#!/usr/bin/env python
"""Smoke test of the main path on the card.

    python chip_smoke.py             # phases (a)-(e) on one GPU
    python chip_smoke.py --chips 4   # phase (f) only, on four GPUs

Llama-3.1-8B at full width with dummy packed weights drawn on the device
from a seed, in the "sum2mix" configuration (tcq2s_6 on qkv/o/gate-up,
tcq2s_8 on down, merged qkv and gate-up), through the entry points a user
calls (runtime/loader, models/llama, runtime/decode, runtime/serving).

  (a) device: JAX's platform / device_kind / count and nvidia-smi.
  (b) kernels: the decode-GEMV kernel compiled for the card at every 8B
      projection width, for tcq2s_6 and tcq2s_8, rows 1 and 8, against the
      f32 reference (weights decoded in f32, product at HIGHEST).
  (c) main path: generate_fast at bs=1 for 32 tokens (4-bit lm_head);
      ContinuousBatcher (4 slots, int8 lm_head) answering 6 requests of
      128 prompt + 32 new tokens; one greedy request against generate().
  (d) logits: one prefill and one decode step of the chosen path against
      the plain f32 path under default_matmul_precision("highest").  The
      bound is 2e-2 of max|logit|, or 1.5x the error of the plain path
      with bf16 activations when that is larger: a model whose activations
      are bf16 cannot be held closer to f32 than its plain bf16 self.
  (e) quantizer: tcq2s_6 and tcq_6 on a seeded 4096x4096 Gaussian through
      quantize_linear, relative MSE against assets/quant_err.json.
  (f) with --chips 4 only: the tensor-parallel shard_map forward
      (parallel/tp.py) on a (dp, tp) = (1, 4) mesh (parallel/sharding.py)
      against the one-card forward, at the 8B widths, 4 layers.

Every phase raises on failure; nothing is caught.  Without a GPU the
script exits non-zero before any phase and prints no result.  The last
stdout line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

SHAPES = {  # projection group: (m, k) at the Llama-3.1-8B widths
    "qkv": (6144, 4096), "o": (4096, 4096), "ug": (28672, 4096),
    "down": (4096, 14336), "lm_head": (131072, 4096),
}
KERNEL_QUANTIZERS = ("tcq2s_6_none_0.9", "tcq2s_8_none_0.9")
KERNEL_TOL = 1e-3    # max|Δ| / max|ref|: integer weights, bf16 inputs
LOGIT_TOL = 2e-2     # max|Δ| / max|logit|: bf16 activations vs f32
BF16_FLOOR_MAX = 0.1  # the plain bf16 path itself must stay below this
QUANT_SIZE = 4096
QUANT_TOL = 0.02     # relative, against assets/quant_err.json
PROMPT, NEW, SLOTS, REQUESTS = 128, 32, 4, 6
TP_LAYERS = 4


def log(*a):
    print(*a, flush=True)


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def check(name, value, bound):
    log(f"    {name}: {value:.3e} (bound {bound:.0e})")
    if not value <= bound:
        raise AssertionError(f"{name} = {value} exceeds {bound}")


def compiled_for_card(compiled) -> bool:
    """The compiled program calls the Triton kernel (no interpreter)."""
    return "__gpu$xla.gpu.triton" in compiled.as_text()


def phase_kernels():
    import jax
    import jax.numpy as jnp
    from qpalette_tpu.kernels.trellis_gemv import block_config, decode_gemv
    from qpalette_tpu.runtime.loader import (_params_from_artifact,
                                             _spec_from_meta, dummy_artifact)
    from qpalette_tpu.runtime.qlinear import dequant_weight_t

    log("[b] kernels: decode-GEMV compiled for the card vs the f32 reference")
    rng = np.random.default_rng(1)
    for q in KERNEL_QUANTIZERS:
        for g, (m, k) in SHAPES.items():
            art = dummy_artifact(q, (m, k), seed=7)
            spec = _spec_from_meta(art["meta"], "pallas")
            tr = _params_from_artifact(art, jnp.bfloat16)["trellis_kt"]
            wt = jax.jit(lambda t: dequant_weight_t(
                spec, {"trellis_kt": t}, {}))(tr)
            for rows in (1, 8):
                x = jnp.asarray(rng.standard_normal((rows, k)), jnp.bfloat16)
                ref = jnp.dot(x.astype(jnp.float32), wt,
                              precision=jax.lax.Precision.HIGHEST)
                fn = jax.jit(lambda xx, t: decode_gemv(
                    xx, t, spec.KV[0], spec.mode, m, k))
                compiled = fn.lower(x, tr).compile()
                if not compiled_for_card(compiled):
                    raise AssertionError(f"{g} {q}: no Triton kernel in the "
                                         f"compiled program")
                y = compiled(x, tr)
                mem = compiled.memory_analysis()
                log(f"  {q} {g} m={m} k={k} rows={rows} "
                    f"block={block_config(m, k)} memory_analysis: "
                    f"args={mem.argument_size_in_bytes} "
                    f"out={mem.output_size_in_bytes} "
                    f"temp={mem.temp_size_in_bytes}")
                check(f"{g} rows={rows} max|Δ|/max|ref|", rel_err(y, ref),
                      KERNEL_TOL)
            del wt


def build_8b(lm_head_bits, layers=None, row_parallel_tp=1):
    import jax
    from qpalette_tpu.models.llama import LlamaConfig
    from qpalette_tpu.runtime.loader import (build_quantized_model,
                                             sum2mix_qdict)
    cfg = LlamaConfig.llama31_8b()
    nl = layers or cfg.num_layers
    t0 = time.perf_counter()
    spec, params = build_quantized_model(
        cfg, sum2mix_qdict(nl), merge_info=[["merge_qkv", "merge_ug"]] * nl,
        dummy=True, impl="pallas", num_layers=nl,
        lm_head_bits=lm_head_bits, row_parallel_tp=row_parallel_tp, seed=0)
    jax.block_until_ready(params)
    nbytes = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(params))
    log(f"  built {nl}-layer 8B model, lm_head {lm_head_bits}-bit: "
        f"{nbytes / 1e9:.3f} GB of params in "
        f"{time.perf_counter() - t0:.1f} s")
    return spec, params


def greedy_agrees(spec, params, prompt, got, ref):
    """(equal tokens, gap): token-by-token equality up to the first
    divergence, and there the reference's own logit gap between the two
    tokens over max|logit| (None if none).  Two programs with different
    summation orders may break a near tie differently; phase (d) holds the
    gap to its logit bound."""
    import jax
    import jax.numpy as jnp
    from qpalette_tpu.models import llama
    for i, (a, b) in enumerate(zip(got, ref)):
        if a == b:
            continue
        seq = jnp.asarray([list(prompt) + list(ref[:i])], jnp.int32)
        lg = np.asarray(jax.jit(llama.forward, static_argnums=0)(
            spec, params, seq)[0, -1], np.float64)
        gap = float((lg[b] - lg[a]) / np.abs(lg).max())
        log(f"    greedy tokens diverge at {i}: reference logit gap "
            f"{gap:.3e} of max|logit|")
        return i, gap
    return len(got), None


def phase_main_path():
    import jax
    from qpalette_tpu.runtime.decode import generate, generate_fast
    from qpalette_tpu.runtime.serving import ContinuousBatcher

    log("[c] main path")
    rng = np.random.default_rng(2)
    spec4, params4 = build_8b(4)
    vocab = spec4.config.vocab_size
    prompt = rng.integers(0, vocab, (1, PROMPT)).astype(np.int32)
    seq, st = generate_fast(spec4, params4, prompt, max_new_tokens=NEW,
                            max_seq=PROMPT + NEW)
    new = seq[0, PROMPT:]
    assert seq.shape == (1, PROMPT + NEW), seq.shape
    assert ((new >= 0) & (new < vocab)).all(), new
    log(f"  generate_fast bs=1: {NEW} tokens in range; "
        f"{st['tokens_per_sec']:.1f} tokens/s over the timed scan")

    spec8, params8 = build_8b(8)
    prompts = [rng.integers(0, vocab, PROMPT).tolist()
               for _ in range(REQUESTS)]
    b = ContinuousBatcher(spec8, params8, n_slots=SLOTS,
                          max_seq=PROMPT + NEW + 8, temperature=0.0,
                          top_k=None)
    rids = [b.submit(p, NEW) for p in prompts]
    t0 = time.perf_counter()
    fin = b.run()
    dt = time.perf_counter() - t0
    for r in rids:
        out = np.asarray(fin[r].output)
        assert fin[r].done and out.shape == (NEW,), (r, out.shape)
        assert ((out >= 0) & (out < vocab)).all(), out
    log(f"  ContinuousBatcher: {REQUESTS} requests x {NEW} tokens complete, "
        f"in range ({dt:.1f} s, compiles included)")
    ref, _ = generate(spec8, params8, np.asarray([prompts[0]], np.int32),
                      max_new_tokens=NEW, max_seq=PROMPT + NEW + 8,
                      temperature=0.0)
    ref = ref[0, PROMPT:].tolist()
    same, gap = greedy_agrees(spec8, params8, prompts[0],
                              fin[rids[0]].output, ref)
    log(f"  greedy request vs generate(): {same} of {NEW} tokens equal")
    del params8
    return spec4, params4, prompt, gap


def phase_logits(spec, params, prompt, greedy_gap):
    import jax
    import jax.numpy as jnp
    from qpalette_tpu.models import llama
    from qpalette_tpu.runtime.decode import prefill
    from qpalette_tpu.runtime.loader import with_impl

    log("[d] logits: chosen path vs plain f32 path")
    step = jax.jit(lambda sp, p, t, c, pos: llama.forward(
        sp, p, t, kv_caches=c, cache_pos=pos), static_argnums=0)
    toks = jnp.asarray(prompt)

    def run(sp, p):
        caches = llama.init_kv_caches(sp, 1, PROMPT + 8)
        lp, caches = prefill(sp, p, toks, caches)
        nxt = jnp.asarray([[7]], jnp.int32)
        ld, _ = step(sp, p, nxt, caches, jnp.int32(PROMPT))
        return np.asarray(lp, np.float64), np.asarray(ld, np.float64)

    # the prefill's 128 rows take the plain path (> GEMV_MAX_ROWS), the
    # decode step's one row the kernel
    lp, ld = run(spec, params)
    _, bd = run(with_impl(spec, "xla"), params)
    ref_spec = with_impl(spec, "xla")
    ref_spec = dataclasses.replace(ref_spec, config=dataclasses.replace(
        spec.config, dtype=jnp.float32))
    ref_params = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, params)
    with jax.default_matmul_precision("highest"):
        rp, rd = run(ref_spec, ref_params)
    del ref_params
    floor = max(rel_err(lp, rp), rel_err(bd, rd))
    check("plain bf16 path vs f32 (prefill, decode step)", floor,
          BF16_FLOOR_MAX)
    bound = max(LOGIT_TOL, 1.5 * floor)
    check("prefill max|Δ|/max|logit|", rel_err(lp, rp), bound)
    check("decode step max|Δ|/max|logit|", rel_err(ld, rd), bound)
    if greedy_gap is not None:
        check("greedy divergence logit gap", greedy_gap, bound)


def phase_quantizer():
    from qpalette_tpu.quant.incoherent import quantize_linear

    log("[e] quantizer on the card")
    table = json.load(open(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "assets", "quant_err.json")))
    W = np.random.default_rng(0).standard_normal(
        (QUANT_SIZE, QUANT_SIZE)).astype(np.float32)
    for q in ("tcq2s_6_none_0.9", "tcq_6_none_0.9"):
        t0 = time.perf_counter()
        err = quantize_linear(W, q, seed=0)["meta"]["err"]
        log(f"  {q}: relative MSE {err:.6f} vs table {table[q]:.6f} "
            f"({time.perf_counter() - t0:.1f} s)")
        check(f"{q} |err - table| / table", abs(err - table[q]) / table[q],
              QUANT_TOL)


def phase_tp(n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from qpalette_tpu.models.llama import forward
    from qpalette_tpu.parallel import tp as tpmod
    from qpalette_tpu.parallel.sharding import make_mesh

    log(f"[f] tensor-parallel shard_map forward on {n} cards")
    spec, params = build_8b(8, layers=TP_LAYERS, row_parallel_tp=n)
    one = jax.jit(forward, static_argnums=0)
    mesh = make_mesh(n, tp=n)
    sparams = tpmod.shard_tp_params(params, spec, mesh)
    fwd = tpmod.tp_forward_fn(spec, mesh, params)
    rng = np.random.default_rng(3)
    for B, S in ((1, 8), (2, 32)):  # 8 rows: kernel; 64 rows: plain path
        toks = jnp.asarray(rng.integers(0, spec.config.vocab_size, (B, S)),
                           jnp.int32)
        ref = one(spec, params, toks)
        out = fwd(sparams, jax.device_put(toks, NamedSharding(mesh, P())))
        check(f"tp={n} vs one card, tokens {B}x{S}: max|Δ|/max|logit|",
              rel_err(out, ref), LOGIT_TOL)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    from qpalette_tpu.utils.compile_cache import enable_compile_cache
    from qpalette_tpu.utils.device import nvidia_smi, require_gpu
    dev = require_gpu()  # raises without a GPU: no phase runs on the CPU
    enable_compile_cache()
    if dev["count"] < args.chips:
        raise RuntimeError(f"--chips {args.chips} but JAX sees "
                           f"{dev['count']} GPU(s)")
    if os.environ.get("QPALETTE_INTERPRET") == "1":
        raise RuntimeError("QPALETTE_INTERPRET=1: chip_smoke runs only "
                           "compiled kernels")
    smi = nvidia_smi()
    log(f"[a] device: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    log(f"[a] nvidia-smi name, power.limit: {smi}")
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_tp(4)
    else:
        phase_kernels()
        spec, params, prompt, gap = phase_main_path()
        phase_logits(spec, params, prompt, gap)
        del params
        phase_quantizer()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
