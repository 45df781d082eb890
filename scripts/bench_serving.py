#!/usr/bin/env python
"""Continuous-batching throughput (the serving engine's number).

Measures aggregate decode tokens/s of runtime/serving.ContinuousBatcher on
the 8B sum2mix config (int8 lm_head) with n_slots concurrent requests,
plus the chunked-prefill admission cost.  Needs a GPU; prints one JSON
line naming the device.  --layers N measures an N-layer model and says
so; nothing is scaled up.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=128)
    ap.add_argument("--new_tokens", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefill_chunk", type=int, default=256)
    args = ap.parse_args()

    from qpalette_tpu.utils.compile_cache import enable_compile_cache
    from qpalette_tpu.utils.device import nvidia_smi, require_gpu
    dev = require_gpu()
    enable_compile_cache()
    from qpalette_tpu.models.llama import LlamaConfig
    from qpalette_tpu.runtime.loader import (build_quantized_model,
                                             sum2mix_qdict)
    from qpalette_tpu.runtime.serving import ContinuousBatcher

    cfg = LlamaConfig.llama31_8b()
    spec, params = build_quantized_model(
        cfg, sum2mix_qdict(args.layers),
        merge_info=[["merge_qkv", "merge_ug"]] * args.layers, dummy=True,
        impl="pallas", num_layers=args.layers, lm_head_bits=8)

    rng = np.random.default_rng(0)
    b = ContinuousBatcher(spec, params, n_slots=args.slots,
                          max_seq=args.prompt_len + args.new_tokens + 8,
                          prefill_chunk=args.prefill_chunk)
    # warm compile: a FULL slot pool of requests end-to-end (the burst
    # scan is jitted per static burst length and batched admission per
    # (batch, chunk) shape — warming with fewer would leave steady-state
    # compiles inside the timed loop)
    for _ in range(args.slots):
        b.submit(list(rng.integers(0, 1000, args.prompt_len)),
                 args.new_tokens)
    b.run()
    b.finished.clear()

    for _ in range(args.requests):
        b.submit(list(rng.integers(0, 1000, args.prompt_len)),
                 args.new_tokens)
    # phase instrumentation: time admission (prefill) vs decode bursts
    admit_t = [0.0]
    _admit0 = b._admit

    def timed_admit():
        # only sync/time when something was actually admitted
        if not b.queue:
            _admit0()
            return
        t = time.perf_counter()
        _admit0()
        np.asarray(b.caches[0][0][0, 0, 0, :1])
        admit_t[0] += time.perf_counter() - t
    b._admit = timed_admit
    t0 = time.perf_counter()
    b.run()
    dt = time.perf_counter() - t0
    print(f"admission (prefill) time: {admit_t[0]:.2f}s of {dt:.2f}s",
          flush=True)
    toks = sum(len(r.output) for r in b.finished.values())
    print(json.dumps({
        "metric": f"continuous-batching decode tokens/s "
                  f"({args.slots} slots, {args.layers}/{cfg.num_layers}-"
                  f"layer Llama-3.1-8B sum2mix, int8 lm_head)",
        "value": round(toks / dt, 2),
        "unit": "tokens/s",
        "raw_tokens": toks, "seconds": round(dt, 2),
        "admission_s": round(admit_t[0], 2),
        "prefill_chunk": args.prefill_chunk,
        "device": dev,
        "nvidia_smi": nvidia_smi(),
    }))


if __name__ == "__main__":
    main()
