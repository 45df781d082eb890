"""Data-free quantizer proxy-error tables + latency coefficient fitting.

Reference behavior:
  - assets/quant_err.pt: relative MSE of each quantizer on a random
    4096×4096 Gaussian weight (generator lib/utils/mem_op.py:336-426).
  - assets/{model}_latency_coeffs_{node}.pt: measured per
    {proj|merge-group} × quantizer × kernel-variant decode seconds plus a
    'constant' term, fitted on the target hardware (consumed by
    solve_lat_const.py:113-123).

Both are regenerated natively here (the latency table is measured on the
card by fit_latency_coeffs.py), cached as JSON under assets/.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from qpalette_tpu.ops.codebooks import _ASSET_DIR
from qpalette_tpu.quant.incoherent import parse_quantizer_str
from qpalette_tpu.quant import quantizers


def _cache(name: str) -> str:
    os.makedirs(_ASSET_DIR, exist_ok=True)
    return os.path.join(_ASSET_DIR, name)


def quantizer_proxy_err(qstr: str, size: int = 4096, seed: int = 0) -> float:
    """Relative MSE of quantizing a size×size N(0,1) matrix (data-free).

    Mirrors mem_op.cache_quantizer_err: the scale_override from the
    quantizer_str is applied to the matrix and divided back out of Wscale.
    """
    spec = parse_quantizer_str(qstr)
    rng = np.random.default_rng(seed)
    Wr = jnp.asarray(rng.standard_normal((size, size)).astype(np.float32))
    s = spec.scale_override
    # Scaling conventions: the LUT families keep the `s / cbr` transform —
    # it reproduces the reference's published assets/quant_err.pt values
    # EXACTLY (tcq_6 0.01891, test_proxy_err_matches_reference_published).
    # The arithmetic families use the quantize-side convention
    # (incoherent.quantize_linear: input RMS = cb_rms * scale_override =
    # s * cbr for unit-RMS Wr).  For RMS-1 codebooks (1mad/2mad/dualmad)
    # the two agree to <0.1%; for sum2 (2-byte sums, RMS 1/sqrt2) the old
    # transform overdrove the signal 2x vs the deployed scaling and
    # inflated tcq2s proxy errs ~5x (round-4 fix).
    if spec.family == "tcq":
        from qpalette_tpu.ops.codebooks import (trellis_lut, lut_rms,
                                                tlut_bits_for_kv)
        cbr = lut_rms(trellis_lut(tlut_bits_for_kv(spec.KV[0])))
        _, hat = quantizers.quantize_mat_tcq(Wr * (s / cbr), None,
                                             spec.KV[0])
        hat = hat * (cbr / s)
    elif spec.family == "tcomb":
        from qpalette_tpu.ops.codebooks import (trellis_lut, lut_rms,
                                                tlut_bits_for_kv)
        cbr = lut_rms(trellis_lut(tlut_bits_for_kv(max(spec.KV))))
        _, hat = quantizers.quantize_mat_combt(Wr * (s / cbr), None,
                                               spec.KV[0], spec.KV[1])
        hat = hat * (cbr / s)
    elif spec.family in ("tcq1", "tcq1x2"):
        from qpalette_tpu.ops.codebooks import trellis_lut_arith, lut_rms
        mode = "1mad" if spec.family == "tcq1" else "2mad"
        cbr = lut_rms(trellis_lut_arith(mode))
        _, hat = quantizers.quantize_mat_tcq1(Wr * (s * cbr), None,
                                              spec.KV[0], mode=mode)
        hat = hat / (s * cbr)
    elif spec.family in ("tcq2", "tcq2s"):
        from qpalette_tpu.ops.codebooks import trellis_lut_arith, lut_rms
        mode = "sum2" if spec.family == "tcq2s" else "dualmad"
        cbr = lut_rms(trellis_lut_arith(mode))
        _, hat = quantizers.quantize_mat_tcq2(Wr * (s * cbr), None,
                                              spec.KV[0], mode=mode)
        hat = hat / (s * cbr)
    elif spec.family == "ldlq":
        _, hat = quantizers.quantize_mat_vq(Wr * s, None, spec.bits,
                                            spec.vec)
        hat = hat / s
    else:
        raise ValueError(spec.family)
    err = float(jnp.mean((hat - Wr) ** 2) / jnp.mean(Wr ** 2))
    return err


def build_err_table(qlist: List[str], size: int = 4096,
                    cache_name: Optional[str] = "quant_err.json",
                    verbose: bool = True) -> Dict[str, float]:
    path = _cache(cache_name) if cache_name else None
    table = {}
    if path and os.path.exists(path):
        table = json.load(open(path))
    for q in qlist:
        if q not in table:
            t0 = time.time()
            table[q] = quantizer_proxy_err(q, size=size)
            if verbose:
                print(f"  err[{q}] = {table[q]:.5f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if path:  # incremental save: entries are expensive
                json.dump(table, open(path, "w"), indent=1)
    return table


def uniform_err_coeffs(num_layers: int) -> Dict[str, float]:
    """Flat sensitivity (fallback when no calibration data is available;
    the reference ships measured coefficients in assets/3_8b_err_coeffs.pt)."""
    from qpalette_tpu.msq.memmodel import LAYER_KEYS
    return {f"{i}_{k}": 1.0 for i in range(num_layers) for k in LAYER_KEYS}
