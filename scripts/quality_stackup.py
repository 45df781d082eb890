#!/usr/bin/env python
"""Quality stack-up regression: CE/logit deltas across the lm_head
variants the decode configuration stacks on the quantized decoder.

There are no model weights in the repository, so absolute perplexity is
out of reach; what IS measurable is the numeric path: the 16/8/4-bit
lm_head variants on top of the quantized projections.  This script builds
a fixed-seed dummy-quantized model (Llama-3.2-1B config shapes by default)
and measures, on a fixed token sequence:

  * teacher-forced CE under every lm_head_bits choice
  * max/mean |logit delta| vs the bf16-head reference

Deltas are pinned in assets/quality_stackup.json (generated on an H100,
the card named in the file); tests assert the numbers stay within bounds.

Usage: python scripts/quality_stackup.py [--config 3_1b|tiny]
       [--out assets/quality_stackup.json] [--layers N]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_stackup(config="3_1b", layers=None, seq=96, seed=0):
    import jax
    import jax.numpy as jnp
    from qpalette_tpu.models.llama import LlamaConfig, forward
    from qpalette_tpu.runtime.loader import (LAYER_KEYS,
                                             build_quantized_model,
                                             sum2mix_qdict)

    cfg = {"3_1b": LlamaConfig.llama32_1b,
           "3_8b": LlamaConfig.llama31_8b,
           "tiny": LlamaConfig.tiny}[config]()
    nl = layers or cfg.num_layers

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (1, seq), dtype=np.int32)
    toks = jnp.asarray(toks)

    def mixes():
        yield "tcq2s_bench", sum2mix_qdict(nl)
        yield "tcomb_325", {
            f"{i}_{k}": "tcomb_6_7_0.5_none_0.9"
            for i in range(nl) for k in LAYER_KEYS}

    def ce_of(logits, toks):
        lg = logits[:, :-1].astype(jnp.float32)
        tg = toks[:, 1:]
        ls = jax.nn.log_softmax(lg, axis=-1)
        return float(-jnp.mean(
            jnp.take_along_axis(ls, tg[..., None], axis=-1)))

    results = {"config": config, "layers": nl, "seq": seq, "seed": seed}
    for mix_name, qd in mixes():
        sub = {}
        ref_logits = None
        # (impl, lm_bits): bf16-head reference first
        for impl, lmb in (("pallas", 16), ("pallas", 8), ("pallas", 4)):
            spec, params = build_quantized_model(
                cfg, qd, dummy=True, impl=impl, num_layers=nl,
                lm_head_bits=lmb, seed=seed)
            logits = np.asarray(forward(spec, params, toks)
                                .astype(jnp.float32))
            ce = ce_of(jnp.asarray(logits), toks)
            key = f"{impl}_lm{lmb}"
            entry = {"ce": round(ce, 5)}
            if ref_logits is None:
                ref_logits = logits
                ref_ce = ce
            scale = float(np.abs(ref_logits).max())
            entry["max_logit_delta_rel"] = round(
                float(np.abs(logits - ref_logits).max()) / scale, 5)
            entry["mean_logit_delta_rel"] = round(
                float(np.abs(logits - ref_logits).mean()) / scale, 6)
            entry["ce_delta"] = round(ce - ref_ce, 5)
            sub[key] = entry
            print(f"{mix_name} {key}: CE {ce:.4f} "
                  f"(d={entry['ce_delta']:+.4f}), "
                  f"max|dlogit|/|ref| {entry['max_logit_delta_rel']:.4f}",
                  flush=True)
        results[mix_name] = sub
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="3_1b",
                    choices=["3_1b", "3_8b", "tiny"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--out", default="assets/quality_stackup.json")
    args = ap.parse_args()
    res = run_stackup(args.config, args.layers, args.seq)
    import jax
    if jax.devices()[0].platform == "gpu":
        from qpalette_tpu.utils.device import nvidia_smi, require_gpu
        res["device"] = require_gpu()
        res["nvidia_smi"] = nvidia_smi()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    json.dump(res, open(args.out, "w"), indent=1)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
