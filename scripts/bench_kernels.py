#!/usr/bin/env python
"""Decode-GEMV kernel against XLA's plain path, on the card, at the
Llama-3.1-8B widths (sum2mix formats: tcq2s_6 / tcq2s_8).

For each projection group it checks the kernel against the f32 reference
(weights decoded in f32, product at HIGHEST precision) and times, at rows
1 and 8, the kernel (impl='pallas') and the plain path (impl='xla': decode
the packed weight to W^T, then one matmul with f32 accumulation).  Then
the row crossover on the gate-up shape, and the whole decode step of the
32-layer model under each impl at bs 1 and 8.  Needs a GPU.

    python scripts/bench_kernels.py [--sweep] [--skip_model]

Per-op times are slopes of an in-jit loop (two trip counts), so dispatch
is excluded; an optimization barrier keeps XLA from hoisting the decode
out of the loop.  The decode step is timed per dispatch, as a server runs
it.  Writes chiprun_out/bench_kernels.json.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPES = {  # group: (m, k, quantizer of the sum2mix)
    "qkv": (6144, 4096, "tcq2s_6_none_0.9"),
    "o": (4096, 4096, "tcq2s_6_none_0.9"),
    "ug": (28672, 4096, "tcq2s_6_none_0.9"),
    "down": (4096, 14336, "tcq2s_8_none_0.9"),
    "lm_head": (131072, 4096, "tcq2s_8_none_0.9"),
}


def slope_time(fn, args, r1=10, r2=40):
    """Seconds per call of fn(*args) -> array, from an in-jit loop."""
    import jax
    import jax.numpy as jnp

    def make(reps):
        def run(x, rest):
            def body(_, carry):
                xx, acc = carry
                rr = jax.lax.optimization_barrier((rest, xx))[0]
                s = jnp.sum(fn(xx, *rr).astype(jnp.float32))
                xx = (xx.astype(jnp.float32) + s * 1e-30).astype(xx.dtype)
                return xx, acc + s
            return jax.lax.fori_loop(0, reps, body,
                                     (x, jnp.float32(0)))[1]
        return jax.jit(run)

    ts = {}
    for reps in (r1, r2):
        f = make(reps)
        f(args[0], args[1:]).block_until_ready()
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            f(args[0], args[1:]).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        ts[reps] = best
    return (ts[r2] - ts[r1]) / (r2 - r1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep the kernel's block configuration")
    ap.add_argument("--skip_model", action="store_true")
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()

    from qpalette_tpu.utils.compile_cache import enable_compile_cache
    from qpalette_tpu.utils.device import nvidia_smi, require_gpu
    enable_compile_cache()
    dev = require_gpu()
    smi = nvidia_smi()
    print(f"device: {dev}  nvidia-smi: {smi}", flush=True)

    import jax
    import jax.numpy as jnp
    from qpalette_tpu.kernels.trellis_gemv import block_config, decode_gemv
    from qpalette_tpu.runtime.loader import (_params_from_artifact,
                                             _spec_from_meta, dummy_artifact)
    from qpalette_tpu.runtime.qlinear import dequant_weight_t, qlinear_apply

    rec = {"device": dev, "nvidia_smi": smi, "ops": {}, "sweep": {},
           "crossover": {}, "decode_step": {}}
    rng = np.random.default_rng(0)
    for g, (m, k, q) in SHAPES.items():
        art = dummy_artifact(q, (m, k), seed=1)
        art["Wscale"] = np.ones((m,), np.float32)
        p = _params_from_artifact(art, jnp.bfloat16)
        sk = _spec_from_meta(art["meta"], "pallas")
        sx = _spec_from_meta(art["meta"], "xla")
        tr = p["trellis_kt"]
        KV, mode = sk.KV[0], sk.mode
        x8 = jnp.asarray(rng.standard_normal((8, k)), jnp.bfloat16)
        wt = jax.jit(lambda t: dequant_weight_t(sx, {"trellis_kt": t}, {})
                     )(tr)
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jnp.dot(x8.astype(jnp.float32), wt,
                                     precision=jax.lax.Precision.HIGHEST))
        del wt
        got = np.asarray(decode_gemv(x8, tr, KV, mode, m, k))
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        lowered = jax.jit(lambda x, t: decode_gemv(x, t, KV, mode, m, k)
                          ).lower(x8[:1], tr)
        mem = lowered.compile().memory_analysis()
        r = {"m": m, "k": k, "quantizer": q, "rel_err_rows8": err,
             "block_config": block_config(m, k),
             "packed_bytes": int(tr.size * 4),
             "temp_bytes": int(getattr(mem, "temp_size_in_bytes", -1))}
        for rows in (1, 8):
            x = x8[:rows]
            tk = slope_time(lambda xx, pp: qlinear_apply(sk, pp, xx),
                            (x, p))
            tx = slope_time(lambda xx, pp: qlinear_apply(sx, pp, xx),
                            (x, p))
            r[f"kernel_us_rows{rows}"] = tk * 1e6
            r[f"xla_us_rows{rows}"] = tx * 1e6
        rec["ops"][g] = r
        print(g, json.dumps(r), flush=True)
        if args.sweep and g in ("ug", "down"):
            for bm in (16, 32, 64):
                for nw in (4, 8):
                    for prog in (528, 1056):
                        _, ks = block_config(m, k, bm=bm, programs=prog)
                        try:
                            t = slope_time(
                                lambda xx, tt: decode_gemv(
                                    xx, tt, KV, mode, m, k, bm=bm, ks=ks,
                                    num_warps=nw), (x8[:1], tr))
                        except Exception as e:  # record refusals
                            t = float("nan")
                            print(f"sweep {g} bm={bm} nw={nw}: "
                                  f"{type(e).__name__}: {str(e)[:200]}")
                        key = f"bm{bm}_nw{nw}_ks{ks}"
                        rec["sweep"].setdefault(g, {})[key] = t * 1e6
            best = min(rec["sweep"][g].items(), key=lambda kv: kv[1])
            print(f"sweep {g}: best {best}", flush=True)

    m, k, q = SHAPES["ug"]
    art = dummy_artifact(q, (m, k), seed=1)
    p = _params_from_artifact(art, jnp.bfloat16)
    sk = _spec_from_meta(art["meta"], "pallas")
    sx = _spec_from_meta(art["meta"], "xla")
    for rows in (1, 2, 4, 8, 16, 32):
        x = jnp.asarray(rng.standard_normal((rows, k)), jnp.bfloat16)
        from qpalette_tpu.kernels.trellis_gemv import decode_gemv as dg
        tk = slope_time(lambda xx, tt: dg(xx, tt, sk.KV[0], sk.mode, m, k),
                        (x, p["trellis_kt"]))
        tx = slope_time(lambda xx, pp: qlinear_apply(sx, pp, xx), (x, p))
        rec["crossover"][rows] = {"kernel_us": tk * 1e6, "xla_us": tx * 1e6}
        print(f"crossover ug rows={rows}: kernel {tk * 1e6:.1f} us, "
              f"xla {tx * 1e6:.1f} us", flush=True)

    if not args.skip_model:
        from qpalette_tpu.models.llama import LlamaConfig, init_kv_caches
        from qpalette_tpu.runtime.decode import decode_step
        from qpalette_tpu.runtime.loader import (build_quantized_model,
                                                 sum2mix_qdict, with_impl)
        nl = args.layers
        cfg = LlamaConfig.llama31_8b()
        spec, params = build_quantized_model(
            cfg, sum2mix_qdict(nl), merge_info=[["merge_qkv",
                                                 "merge_ug"]] * nl,
            dummy=True, impl="pallas", num_layers=nl, lm_head_bits=4)
        for impl in ("pallas", "xla", "xla", "pallas"):
            sp = with_impl(spec, impl)
            for bs in (1, 8):
                caches = init_kv_caches(sp, bs, 256)
                tok = jnp.ones((bs, 1), jnp.int32)
                key = jax.random.PRNGKey(0)
                t0 = time.perf_counter()
                tok, caches = decode_step(sp, params, tok, caches,
                                          jnp.int32(0), key)
                tok.block_until_ready()
                t_first = time.perf_counter() - t0
                n = 32
                t0 = time.perf_counter()
                for i in range(n):
                    tok, caches = decode_step(sp, params, tok, caches,
                                              jnp.int32(1 + i), key)
                tok.block_until_ready()
                dt = (time.perf_counter() - t0) / n
                rec["decode_step"].setdefault(f"{impl}_bs{bs}", []).append(
                    {"ms_per_step": dt * 1e3, "first_call_s": t_first})
                print(f"decode step {impl} bs={bs}: {dt * 1e3:.3f} ms "
                      f"(first call {t_first:.1f} s)", flush=True)
                del caches
        print("peak bytes in use:", (jax.devices()[0].memory_stats()
                                     or {}).get("peak_bytes_in_use"))

    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bench_kernels.json", "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"ok": True, "device": dev}))


if __name__ == "__main__":
    main()
