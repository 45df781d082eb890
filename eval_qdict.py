#!/usr/bin/env python
"""WikiText-2 perplexity of a quantized model (reference eval_qdict.py).

Usage:
  python eval_qdict.py --model meta-llama/Llama-3.1-8B \
      --qdict_path msq_results/3_8b/mem_constrained/default/3.25bit.json
  python eval_qdict.py --quantizer_str tcomb_6_7_0.5_none_0.9

Quantizes layers on demand (cached under quant_results/, resumable at
layer granularity) and evaluates ctx-8192 perplexity.  Requires local HF
weights + the wikitext dataset in the local cache (no network egress).
"""

import argparse
import json
import os


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qdict_path", default=None)
    ap.add_argument("--merge_info_path", default=None)
    ap.add_argument("--quantizer_str", default=None)
    ap.add_argument("--ctx_size", type=int, default=8192)
    ap.add_argument("--save_dir", default="quant_results")
    ap.add_argument("--impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--num_layers", type=int, default=-1)
    ap.add_argument("--re_eval", action="store_true")
    ap.add_argument("--hess_path", default=None,
                    help="npz of {i}_{group}: H from collect_hessians.py")
    ap.add_argument("--dataset", default="wikitext2",
                    choices=["wikitext2", "ptb", "c4"])
    args = ap.parse_args()

    from qpalette_tpu.runtime.loader import (MODEL_KEYS, CONFIGS,
                                             build_quantized_model)
    from qpalette_tpu.runtime.evaluate import eval_ppl, DATASET_LOADERS
    from qpalette_tpu.models.hf_weights import (find_local_checkpoint,
                                                load_dense_params,
                                                config_from_hf)

    model_key = MODEL_KEYS.get(args.model, "custom")

    if args.quantizer_str is not None:
        qdict = args.quantizer_str
        result_path = f"msq_results/{model_key}/{args.quantizer_str}_result"
    else:
        qdict = json.load(open(args.qdict_path))
        qdict = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in qdict.items()}
        result_path = args.qdict_path.replace(".json", "_result")
    if os.path.exists(result_path + ".json") and not args.re_eval:
        print("cached:", json.load(open(result_path + ".json")))
        return

    merge_info = None
    if args.merge_info_path:
        merge_info = json.load(open(args.merge_info_path))

    ckpt = find_local_checkpoint(args.model)
    if ckpt is None:
        raise SystemExit(
            f"no local checkpoint for {args.model}; quantized eval needs "
            f"real weights (use measure_latency.py --dummy for latency-only)")
    cfg = config_from_hf(ckpt)
    nl = args.num_layers if args.num_layers > 0 else cfg.num_layers
    print(f"loading dense weights from {ckpt} ({nl} layers)")
    dense = load_dense_params(ckpt, cfg, num_layers=nl)

    hess = None
    if args.hess_path:
        import numpy as np
        hess = dict(np.load(args.hess_path))

    spec, params = build_quantized_model(
        cfg, qdict, merge_info=merge_info, model_key=model_key,
        save_dir=args.save_dir, seed=args.seed, dense_params=dense,
        impl=args.impl, num_layers=nl, hess=hess)

    toks = DATASET_LOADERS[args.dataset](args.model)
    ppl, avg_loss = eval_ppl(spec, params, toks, ctx_size=args.ctx_size)
    print(f"ppl: {ppl}, avg_loss: {avg_loss}")

    os.makedirs(os.path.dirname(result_path) or ".", exist_ok=True)
    json.dump({args.dataset: {"ppl": ppl, "avg_loss": avg_loss}},
              open(result_path + ".json", "w"), indent=1)
    with open(result_path + ".txt", "w") as f:
        f.write(f"{args.dataset}, {ppl}, {avg_loss}\n")


if __name__ == "__main__":
    main()
