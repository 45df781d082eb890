"""bs=1 decode throughput of a quantized Llama-3.1-8B on the card.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "tokens/s", "vs_baseline": N,
   "device": {...}, ...}

Baseline: reference Q-Palette ~195 tok/s (RTX 4090, latency-constrained
MSQ, README.md:101).  Weights are dummy packed bits drawn on the device
from a seed (the reference's --dummy latency mode, mem_op.py:198-269):
decode throughput does not depend on weight values.  Needs a GPU; the
run names the device and fails without one.

Env overrides: QPT_BENCH_LAYERS (default 32; a shallower model is
reported as such, never scaled up), QPT_BENCH_TOKENS, QPT_BENCH_SCHEME
(sum2mix | tcq1mix | tcq2mix | a quantizer_str), QPT_BENCH_QDICT (a solver
qdict JSON, with its _merge_info.json beside it; must exist),
QPT_BENCH_IMPL (pallas | xla), QPT_BENCH_LMBITS (16 | 8 | 4),
QPT_BENCH_MERGE (1 | 0), QPT_BENCH_BURSTS.
"""

import json
import os

import numpy as np

BASELINE_TOKS = 195.0


def hand_mix(scheme: str, nl: int) -> dict:
    """3.27-bit arithmetic-trellis mixes, merge-compatible within each
    fused group (same KV and mode):
      sum2mix: qkv/o/ug tcq2s_6 (3.0 b), down tcq2s_8 (4.0 b)
      tcq2mix: qkv tcq2_6, ug tcq2_7, o/down tcq1_3
      tcq1mix: qkv/o/down tcq1_3, ug tcq1_4"""
    from qpalette_tpu.runtime.loader import LAYER_KEYS, sum2mix_qdict
    if scheme == "sum2mix":
        return sum2mix_qdict(nl)
    ug = {"tcq2mix": "tcq2_7_none_0.9", "tcq1mix": "tcq1_4_none_0.9"}[scheme]
    qkv = {"tcq2mix": "tcq2_6_none_0.9", "tcq1mix": "tcq1_3_none_0.9"}[scheme]
    qd = {}
    for i in range(nl):
        for key in LAYER_KEYS:
            if key in ("mlp.up_proj", "mlp.gate_proj"):
                qd[f"{i}_{key}"] = ug
            elif key in ("self_attn.o_proj", "mlp.down_proj"):
                qd[f"{i}_{key}"] = "tcq1_3_none_0.9"
            else:
                qd[f"{i}_{key}"] = qkv
    return qd


def main():
    from qpalette_tpu.utils.compile_cache import enable_compile_cache
    from qpalette_tpu.utils.device import nvidia_smi, peaks, require_gpu
    dev = require_gpu()
    peak = peaks(dev["kind"])
    enable_compile_cache()
    from qpalette_tpu.models.llama import LlamaConfig
    from qpalette_tpu.runtime.loader import build_quantized_model
    from qpalette_tpu.runtime.decode import generate_fast, model_bytes

    scheme = os.environ.get("QPT_BENCH_SCHEME", "sum2mix")
    qdict_path = os.environ.get("QPT_BENCH_QDICT")
    impl = os.environ.get("QPT_BENCH_IMPL", "pallas")
    cfg = LlamaConfig.llama31_8b()
    nl = int(os.environ.get("QPT_BENCH_LAYERS", str(cfg.num_layers)))
    n_tokens = int(os.environ.get("QPT_BENCH_TOKENS", "256"))
    lm_bits = int(os.environ.get("QPT_BENCH_LMBITS", "4"))
    merge = os.environ.get("QPT_BENCH_MERGE", "1") == "1"

    mi = [["merge_qkv", "merge_ug"]] * nl if merge else None
    if qdict_path:
        qd = {k: tuple(v) if isinstance(v, list) else v
              for k, v in json.load(open(qdict_path)).items()
              if int(k.split("_", 1)[0]) < nl}
        mp = qdict_path[:-len(".json")] + "_merge_info.json"
        if os.path.exists(mp):
            mi = json.load(open(mp))[:nl]
        label = f"qdict {os.path.basename(qdict_path)}"
    elif scheme in ("sum2mix", "tcq1mix", "tcq2mix"):
        qd = hand_mix(scheme, nl)
        label = f"3.27-bit {scheme}"
    else:
        qd = scheme
        label = scheme
    spec, params = build_quantized_model(
        cfg, qd, merge_info=mi, dummy=True, impl=impl, num_layers=nl,
        lm_head_bits=lm_bits)
    prompt = np.array([[1]], dtype=np.int32)
    # timed bursts, matching the reference's 3-sample methodology
    # (measure_latency.py:236-273): the value is the mean, best-of beside
    rates = []
    for _ in range(int(os.environ.get("QPT_BENCH_BURSTS", "3"))):
        _, s = generate_fast(spec, params, prompt, max_new_tokens=n_tokens,
                             max_seq=2 * n_tokens, temperature=0.6, top_k=5)
        rates.append(s["tokens_per_sec"])
    toks = float(np.mean(rates))
    # streamed bytes per token: every weight except the embedding table
    # (one row gathered per token); KV-cache reads are omitted
    streamed = model_bytes(params) - params["embed"].size * \
        params["embed"].dtype.itemsize
    gbps = streamed * toks / 1e9
    lm_label = {16: "bf16", 8: "int8", 4: "4-bit tcq2s"}[lm_bits]
    print(json.dumps({
        "metric": (f"decode tokens/s bs=1 Llama-3.1-8B {nl}/"
                   f"{cfg.num_layers} layers {label} ({lm_label} lm_head, "
                   f"impl {impl}, mean of {len(rates)} bursts)"),
        "value": round(toks, 2),
        "unit": "tokens/s",
        "vs_baseline": round(toks / BASELINE_TOKS, 4),
        "best_tokens_per_sec": round(float(np.max(rates)), 2),
        "burst_samples": [round(float(r), 2) for r in rates],
        "achieved_GBps": round(gbps, 1),
        "streamed_GB_per_token": round(streamed / 1e9, 3),
        "hbm_roofline_frac": round(gbps * 1e9 / peak["hbm_bytes_per_s"], 3),
        "device": dev,
        "nvidia_smi": nvidia_smi(),
    }))


if __name__ == "__main__":
    main()
