#!/usr/bin/env python
"""Latency-constrained fusion-aware MSQ solve (reference solve_lat_const.py
CLI parity).

Usage:
  python fit_latency_coeffs.py --model meta-llama/Llama-3.1-8B   # on the card
  python solve_lat_const.py --model meta-llama/Llama-3.1-8B \
      --target_thp 200 --nodename NVIDIA_H100_80GB_HBM3 [--no_fuse] [--use_cc]

--use_cc enables the second kernel-impl variant per quantizer (the
reference's SIMT flag; here the XLA dequant path vs the decode-GEMV kernel).
"""

import argparse
import json
import os


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--quantizer_type", default="default",
                    choices=["default"])
    ap.add_argument("--imp_key", default="err", choices=["err"])
    ap.add_argument("--nodename", required=True,
                    help="latency table suffix written by "
                    "fit_latency_coeffs.py (the device_kind)")
    ap.add_argument("--no_fuse", action="store_true")
    ap.add_argument("--target_thp", type=float, default=200)
    ap.add_argument("--use_cc", action="store_true")
    ap.add_argument("--mem_bits", type=float, default=None,
                    help="optional additional memory constraint")
    ap.add_argument("--err_size", type=int, default=4096)
    args = ap.parse_args()

    from qpalette_tpu.runtime.loader import MODEL_KEYS, CONFIGS
    from qpalette_tpu.msq.solver import QDICT_LAT, solve_lat_constrained
    from qpalette_tpu.msq.err_tables import build_err_table

    model_key = MODEL_KEYS[args.model]
    cfg = CONFIGS[model_key]()

    lat_path = f"assets/{model_key}_latency_coeffs_{args.nodename}.json"
    if not os.path.exists(lat_path):
        raise SystemExit(
            f"missing {lat_path}: run fit_latency_coeffs.py first "
            f"on the card (the reference ships this table precomputed for "
            f"the 4090)")
    lat_coeffs = json.load(open(lat_path))

    qlist = list(QDICT_LAT)
    errs = build_err_table(qlist, size=args.err_size)

    err_coeffs = None
    coeff_path = f"assets/{model_key}_err_coeffs.json"
    if os.path.exists(coeff_path):
        err_coeffs = {k: v for k, v in json.load(open(coeff_path)).items()
                      if not k.startswith("__")}

    sol = solve_lat_constrained(
        cfg, qlist, errs, lat_coeffs, args.target_thp,
        err_coeffs=err_coeffs, mem_target_bits=args.mem_bits,
        no_fuse=args.no_fuse, use_impl_choice=args.use_cc)

    print(f"estimated step latency {sol.est_latency * 1e3:.3f} ms "
          f"({1.0 / sol.est_latency:.1f} tok/s), err {sol.est_err:.4f}")

    sub = "lat_constrained" if not args.no_fuse else "lat_constrained_no_fuse"
    out_dir = (f"msq_results/{model_key}/{sub}/{args.nodename}/"
               f"{args.quantizer_type}_{args.imp_key}")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{args.target_thp}thp{'_cc' if args.use_cc else ''}"
    json.dump({k: list(v) for k, v in sol.qdict.items()},
              open(f"{out_dir}/{tag}.json", "w"), indent=1)
    json.dump(sol.merge_info,
              open(f"{out_dir}/{tag}_merge_info.json", "w"), indent=1)
    print(f"saved {out_dir}/{tag}.json (+_merge_info.json)")


if __name__ == "__main__":
    main()
