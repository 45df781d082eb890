#!/usr/bin/env python
"""bs=1 decode throughput (reference eval/measure_latency.py +
measure_latency_merge_simt.py, unified).

Usage (dummy weights — latency only, no checkpoint needed):
  python measure_latency.py --quantizer_str tcomb_6_7_0.5_none_0.9 --dummy
  python measure_latency.py --qdict_path .../200.0thp.json \
      --merge_info_path .../200.0thp_merge_info.json --dummy

Reports tokens/s, achieved GB/s (model bytes × tok/s) and TF/s, mirroring
measure_latency.py:266-273.
"""

import argparse
import json
import os


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hf_path", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--qdict_path", default=None)
    ap.add_argument("--merge_info_path", default="")
    ap.add_argument("--quantizer_str", default=None)
    ap.add_argument("--max_new_tokens", type=int, default=128)
    ap.add_argument("--num_samples", type=int, default=3)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--dummy", action="store_true")
    ap.add_argument("--impl", default="pallas",
                    choices=["pallas", "xla"])
    ap.add_argument("--num_hidden_layers", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save_key", default="")
    args = ap.parse_args()

    import numpy as np
    from qpalette_tpu.runtime.loader import (MODEL_KEYS, CONFIGS,
                                             build_quantized_model)
    from qpalette_tpu.runtime.decode import generate, model_bytes

    model_key = MODEL_KEYS[args.hf_path]
    cfg = CONFIGS[model_key]()
    nl = args.num_hidden_layers if args.num_hidden_layers > 0 \
        else cfg.num_layers

    if args.quantizer_str is not None:
        qdict = args.quantizer_str
    else:
        qdict = json.load(open(args.qdict_path))
        qdict = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in qdict.items()}
    merge_info = None
    if args.merge_info_path:
        merge_info = json.load(open(args.merge_info_path))

    dense = None
    if not args.dummy:
        from qpalette_tpu.models.hf_weights import (find_local_checkpoint,
                                                    load_dense_params)
        ckpt = find_local_checkpoint(args.hf_path)
        if ckpt is not None:
            dense = load_dense_params(ckpt, cfg, num_layers=nl)

    spec, params = build_quantized_model(
        cfg, qdict, merge_info=merge_info, model_key=model_key,
        save_dir="quant_results", seed=args.seed, dense_params=dense,
        dummy=args.dummy and dense is None, impl=args.impl, num_layers=nl)

    mbytes = model_bytes(params)
    print(f"model size: {mbytes / 1e9:.2f} GB")

    prompt = np.ones((args.batch_size, 1), dtype=np.int32)
    all_tps = []
    for i in range(args.num_samples):
        seq, stats = generate(spec, params, prompt,
                              max_new_tokens=args.max_new_tokens,
                              max_seq=2 * args.max_new_tokens)
        tps = stats["tokens_per_sec"]
        all_tps.append(tps)
        print(f"sample {i}: {tps:.2f} tokens/sec, "
              f"bandwidth {mbytes * tps / args.batch_size / 1e9:.1f} GB/s",
              flush=True)

    avg = float(np.mean(all_tps))
    print(f"Average tokens/sec: {avg:.2f}")
    result = {"average_tokens_per_sec": avg, "model_size_gb": mbytes / 1e9,
              "quantizer_str": args.quantizer_str,
              "qdict_path": args.qdict_path, "impl": args.impl,
              "batch_size": args.batch_size, "num_layers": nl}
    if args.save_key:
        out = f"eval_results/latency/{args.hf_path}/{args.save_key}.json"
        os.makedirs(os.path.dirname(out), exist_ok=True)
        json.dump(result, open(out, "w"), indent=1)
        print(f"saved {out}")


if __name__ == "__main__":
    main()
