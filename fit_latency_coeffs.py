#!/usr/bin/env python
"""Measure per-op latency coefficients on the card for the latency-aware
MSQ solver.

Reference behavior: the reference ships measured per-{proj|merge-group} ×
quantizer × kernel-variant decode seconds for the RTX 4090
(assets/3_8b_latency_coeffs_4090_cc.pt, 589 entries + 'constant'),
consumed at solve_lat_const.py:113-123.

Per-op latency is close to an affine function of packed bytes per scheme
family, so the default mode measures a representative SAMPLE grid on the
card (slope-timed in-jit loops), fits the per-family affine model
(msq/latmodel.fit_family_model), and emits the FULL table in the solver's
schema with per-entry provenance: sampled entries carry their direct
measurement, the rest the fit.  --full measures every entry directly.
Needs a GPU.

Output: assets/{model_key}_latency_coeffs_{nodename}.json, nodename
defaulting to the device_kind.
"""

import argparse
import json
import os
import time

import numpy as np

# sample grid: small-m (q), merged attn (qkv), merged mlp (ug), row-long-k
# (d) and o — covers the shapes the fusion-aware solver actually mixes.
# QPT_FIT_GROUPS / QPT_FIT_QS override (comma-separated).
SAMPLE_GROUPS = os.environ.get("QPT_FIT_GROUPS",
                               "q,qkv,o,ug,d").split(",")
SAMPLE_QS = (os.environ["QPT_FIT_QS"].split(",")
             if os.environ.get("QPT_FIT_QS") else
             ["tcq1_3_none_0.9", "tcq1_4_none_0.9", "tcq2_6_none_0.9",
              "tcq2_8_none_0.9", "tcq2s_6_none_0.9", "tcq2s_8_none_0.9",
              "tcq_6_none_0.9", "ldlq_1_4_none_1.0", "ldlq_2_6_none_1.0"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--nodename", default=None,
                    help="table suffix (default: the device_kind)")
    ap.add_argument("--qlist", default="lat", choices=["lat", "mem"])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--impl", default="pallas",
                    help="impl measured (second flag variant = xla)")
    ap.add_argument("--full", action="store_true",
                    help="measure every (group, q) instead of sample+fit")
    ap.add_argument("--constant", type=float, default=None,
                    help="non-projection per-token seconds (attention, "
                    "norms, rotations, lm_head, sampling); default 1 ms")
    args = ap.parse_args()

    from qpalette_tpu.utils.compile_cache import enable_compile_cache
    from qpalette_tpu.utils.device import require_gpu
    dev = require_gpu()
    enable_compile_cache()
    nodename = args.nodename or dev["kind"].replace(" ", "_")
    import jax
    import jax.numpy as jnp
    from qpalette_tpu.runtime.loader import (MODEL_KEYS, CONFIGS,
                                             dummy_artifact,
                                             _params_from_artifact,
                                             _spec_from_meta)
    from qpalette_tpu.runtime.qlinear import qlinear_apply
    from qpalette_tpu.msq.solver import (QDICT_LAT, QDICT_MEM, MERGE_GROUPS,
                                         SIMPLE2KEY)
    from qpalette_tpu.msq.memmodel import layer_shape
    from qpalette_tpu.msq.latmodel import (fit_family_model, family_of,
                                           build_lat_table, packed_bytes)

    model_key = MODEL_KEYS[args.model]
    cfg = CONFIGS[model_key]()
    qlist = list(QDICT_LAT if args.qlist == "lat" else QDICT_MEM)

    groups = list("qkvougd") + list(MERGE_GROUPS)

    def group_shape(g):
        bases = MERGE_GROUPS.get(g, (g,))
        shapes = [layer_shape(cfg, SIMPLE2KEY[b]) for b in bases]
        n = shapes[0][1]
        assert all(s[1] == n for s in shapes)
        return sum(s[0] for s in shapes), n

    REPS = args.reps

    def time_apply(spec, params, n):
        x = jnp.zeros((1, n), jnp.bfloat16)

        def mkloop(reps):
            def loop(x):
                def it(carry, _):
                    xx, acc = carry
                    # the barrier ties the weights to the loop carry, so
                    # XLA cannot hoist their decode out of the loop
                    pp = jax.lax.optimization_barrier((params, xx))[0]
                    y = qlinear_apply(spec, pp, xx)
                    xx = (xx * 0.999 + jnp.sum(y).astype(xx.dtype)
                          * 1e-20).astype(xx.dtype)
                    return (xx, acc + jnp.sum(y)), None
                (xf, acc), _ = jax.lax.scan(it, (x, jnp.float32(0)), None,
                                            length=reps)
                return acc
            return jax.jit(loop)

        ts = {}
        for reps in (REPS, 4 * REPS):  # slope timing kills dispatch cost
            f = mkloop(reps)
            r = f(x)
            np.asarray(jax.device_get(r))
            best = 1e9
            for _ in range(3):
                t0 = time.perf_counter()
                r = f(x)
                np.asarray(jax.device_get(r))
                best = min(best, time.perf_counter() - t0)
            ts[reps] = best
        dt = (ts[4 * REPS] - ts[REPS]) / (3 * REPS)
        if dt <= 1e-7:
            # a non-positive slope would make the solver pick that scheme
            # unboundedly: fail the run
            raise RuntimeError(f"non-positive slope ({dt * 1e6:.1f} us)")
        return dt

    def measure(g, q, impl):
        m, n = group_shape(g)
        art = dummy_artifact(q, (m, n), seed=0)
        spec = _spec_from_meta(art["meta"], impl)
        params = _params_from_artifact(art, jnp.bfloat16)
        return time_apply(spec, params, n)

    pairs = ([(g, q) for g in groups for q in qlist] if args.full else
             [(g, q) for g in SAMPLE_GROUPS for q in SAMPLE_QS])
    samples = []
    measured = {}     # -> `_False` keys (primary fused impl)
    measured_alt = {}  # -> `_True` keys (xla alternate impl, ldlq only:
    #                    the solver's use_impl_choice offers `1` only for
    #                    ldlq quantizers, mirroring the reference simt flag)
    for g, q in pairs:
        byts = packed_bytes(cfg, g, q)
        dt = measure(g, q, args.impl)
        samples.append((family_of(q), byts, dt))
        measured[f"{g}_{q}"] = dt
        print(f"{g}_{q}: {dt * 1e6:.1f} us "
              f"({byts / dt / 1e9:.0f} GB/s)", flush=True)
        if q.startswith("ldlq"):
            dta = measure(g, q, "xla")
            measured_alt[f"{g}_{q}"] = dta
            print(f"{g}_{q} [xla]: {dta * 1e6:.1f} us", flush=True)

    fams = fit_family_model(samples)
    print("family fits (launch_s, s_per_byte):", fams)

    # non-projection per-token remainder (measure_latency refines it)
    constant = 1.0e-3 if args.constant is None else args.constant
    table = build_lat_table(cfg, qlist, fams, constant=constant)
    # overwrite fitted entries with direct measurements where we have them;
    # the `_True` (alternate-impl) keys only get values actually measured
    # with the xla impl — never the fused-impl number (round-2 ADVICE)
    for key, dt in measured.items():
        table[f"{key}_False"] = dt
    for key, dt in measured_alt.items():
        table[f"{key}_True"] = dt
    table["__source__"] = ("measured" if args.full else
                           "measured-sample-fit")
    table["__impl__"] = args.impl
    table["__nodename__"] = nodename
    table["__device__"] = dev
    os.makedirs("assets", exist_ok=True)
    out = f"assets/{model_key}_latency_coeffs_{nodename}.json"
    json.dump(table, open(out, "w"), indent=1)
    print(f"saved {len(table)} coefficients to {out}")


if __name__ == "__main__":
    main()
