"""Quantized-linear dispatch: one apply function per packed scheme.

Reference behavior: lib/linear/{tcq_linear,vq_linear,comb_linear}.py — each
module picks a fused CUDA kernel for bs <= 8 and falls back to
dequant-then-matmul for larger batch (tcq_linear.py:64-84).

`qlinear_apply` dispatches on a hashable LinearSpec at trace time
(replacing the reference's per-shape op registry,
lib/linear/__init__.py:43-420).  Every kind keeps one packed layout on the
device (kernels/formats.py), which both paths read.  The loader records in
`LinearSpec.impl` which path a projection takes:
  - 'xla'    : decode the packed weight to W^T in-graph, then one XLA
               matmul with f32 accumulation.  Every kind; also the large-
               row path of 'pallas'.
  - 'pallas' : the decode-GEMV kernel (kernels/trellis_gemv.py) for the
               arithmetic trellis kinds (tcq1, tcq2) at <= GEMV_MAX_ROWS
               rows.  The loader never assigns it to another kind.
The expanded 2^16-state trellis LUT of the LUT kinds is shared across
layers via the model's `luts` dict (one entry per tlut_bits), mirroring how
all reference TCQ layers share the cached kmeans tlut (bitshift.py:148-160).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

# kinds the decode-GEMV kernel implements
KERNEL_KINDS = ("tcq1", "tcq2")
# rows at or below which impl='pallas' runs the decode-GEMV kernel; above
# it the packed weight is decoded once and the rows ride one matmul (the
# reference splits at bs<=8, tcq_linear.py:64-84).  On an H100 the kernel
# beats the decode-then-matmul path on the 28672x4096 gate-up projection
# up to 16 rows and loses at 32 (see PERF.md)
GEMV_MAX_ROWS = 16


@dataclass(frozen=True)
class LinearSpec:
    kind: str                 # dense | tcq | tcq1 | tcq2 | tcomb | comb | vq
    in_features: int
    out_features: int
    KV: tuple = ()            # (KV,) or (KV1, KV2)
    tlut_bits: int = 0
    bits: int = 0
    vec: int = 0
    split: tuple = ()         # in_part (tcomb) or out_part (comb)
    mode: str = ""            # arithmetic decode mode (1mad|2mad|dualmad|sum2)
    impl: str = "xla"         # xla | pallas

    def tcq_lut_key(self) -> str:
        return f"tcq{self.tlut_bits}"


def resolve_impl(kind: str, impl: str) -> str:
    """The path a projection of `kind` takes when the session asks for
    `impl`: the kernel exists only for KERNEL_KINDS."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown impl {impl!r} (xla | pallas)")
    return impl if kind in KERNEL_KINDS else "xla"


def _trellis_states(tr_kt, KV: int, V: int):
    """(k/16, W, m/16) packed tiles -> (k/16, 256/V, m/16) 16-bit states
    (state s of a tile starts at stream bit s*KV, circular)."""
    from qpalette_tpu.kernels.trellis_gemv import state_windows
    W = tr_kt.shape[1]
    off = jnp.arange(256 // V, dtype=jnp.int32) * KV
    j0 = off >> 5
    lo = jnp.take(tr_kt, j0, axis=1)
    hi = jnp.take(tr_kt, (j0 + 1) % W, axis=1)
    sh = (off & 31).astype(jnp.uint32)[None, :, None]
    return state_windows(lo, hi, sh)


def _tcq_lut_t(tr_kt, lut, KV: int):
    """LUT-decoded V=2 trellis (m-major in the tile: state 8*row + p holds
    weights (row, 2p), (row, 2p+1)) -> W^T (k, m)."""
    kt, _, mt = tr_kt.shape
    vals = jnp.take(lut, _trellis_states(tr_kt, KV, 2).astype(jnp.int32),
                    axis=0)                           # (kt, 128, mt, 2)
    vals = vals.reshape(kt, 16, 8, mt, 2)             # (kt, row, p, mt, c)
    return vals.transpose(0, 2, 4, 3, 1).reshape(kt * 16, mt * 16)


def _arith_int_t(tr_kt, KV: int, mode: str):
    """Arithmetic-decoded trellis (tcq1 k-major / tcq2 paired-k-major:
    state 16*a + row holds weight(s) (row, V*a + c)) -> W^T (k, m) f32 of
    the integer byte sums; the weights are these times MAD_INV."""
    from qpalette_tpu.kernels.trellis_gemv import arith_sums, mode_v
    V = mode_v(mode)
    kt, _, mt = tr_kt.shape
    sums, bias = arith_sums(_trellis_states(tr_kt, KV, V), mode)
    vals = jnp.stack([(s.astype(jnp.int32) - bias).astype(jnp.float32)
                      for s in sums], axis=2)          # (kt, 256/V, V, mt)
    vals = vals.reshape(kt, 16 // V, 16, V, mt)        # (kt, a, row, c, mt)
    return vals.transpose(0, 1, 3, 4, 2).reshape(kt * 16, mt * 16)


def _vq_t(qw_t, lut, bits: int, vec: int):
    """qweight_t (P*bits/32, m) -> W^T (P*vec, m)."""
    P = qw_t.shape[0] * 32 // bits
    off = jnp.arange(P, dtype=jnp.int32) * bits
    j0 = off >> 5
    lo = jnp.take(qw_t, j0, axis=0)
    hi = jnp.take(qw_t, (j0 + 1) % qw_t.shape[0], axis=0)
    sh = (off & 31).astype(jnp.uint32)[:, None]
    idx = ((lo >> sh) | ((hi << (jnp.uint32(31) - sh)) << jnp.uint32(1))
           ) & jnp.uint32((1 << bits) - 1)
    vals = jnp.take(lut, idx.astype(jnp.int32), axis=0)   # (P, m, vec)
    return vals.transpose(0, 2, 1).reshape(P * vec, qw_t.shape[1])


def _decode_t(spec: LinearSpec, p: dict, luts: dict):
    """(W^T f32, s): the weights are W^T * s.  The arithmetic kinds decode
    to their integer byte sums, exact in bf16 for sum2 (|v| <= 256), and
    take the 1/MAD_SCALE factor after the matmul, as the kernel does."""
    if spec.kind in KERNEL_KINDS:
        from qpalette_tpu.kernels.trellis_gemv import MAD_INV
        return _arith_int_t(p["trellis_kt"], spec.KV[0], spec.mode), MAD_INV
    return dequant_weight_t(spec, p, luts), 1.0


def dequant_weight_t(spec: LinearSpec, p: dict, luts: dict) -> jax.Array:
    """Decode packed weights to dense W^T (in, out) f32 (rotated space,
    unscaled by Wscale)."""
    if spec.kind in KERNEL_KINDS:
        wt, s = _decode_t(spec, p, luts)
        return wt * s
    if spec.kind == "vq":
        return _vq_t(p["qweight_t"], p["lut"].astype(jnp.float32),
                     spec.bits, spec.vec)
    lut = luts[spec.tcq_lut_key()].astype(jnp.float32)
    if spec.kind == "tcq":
        return _tcq_lut_t(p["trellis_kt"], lut, spec.KV[0])
    w1 = _tcq_lut_t(p["trellis1_kt"], lut, spec.KV[0])
    w2 = _tcq_lut_t(p["trellis2_kt"], lut, spec.KV[1])
    if spec.kind == "tcomb":  # input split
        return jnp.concatenate([w1, w2], axis=0)
    if spec.kind == "comb":   # output split
        return jnp.concatenate([w1, w2], axis=1)
    raise ValueError(spec.kind)


def qlinear_apply(spec: LinearSpec, p: dict, z: jax.Array,
                  luts: Optional[dict] = None,
                  out_dtype=None) -> jax.Array:
    """z (rows, in_features), already incoherence-rotated -> (rows, out).

    Applies the per-row Wscale epilogue (reference incoherent_linear.py:495).
    out_dtype overrides the output dtype (default: z's dtype) — the
    quantized lm_head passes f32 so final logits skip the bf16 round-trip
    the decoder layers want.  Under impl='xla' the weight is decoded in
    z's dtype, so an f32 model is an f32 reference end to end.
    """
    odt = out_dtype or z.dtype
    if spec.kind in ("dense", "dense_rot"):
        y = jax.lax.dot_general(
            z, p["w"], (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        if spec.kind == "dense_rot":  # rotated-dense baseline (QuaRot-style)
            y = y * p["wscale"][None, :].astype(jnp.float32)
        return y.astype(odt)
    if spec.impl == "pallas":
        if spec.kind not in KERNEL_KINDS:
            raise ValueError(f"impl='pallas' has no kernel for {spec.kind!r}")
    elif spec.impl != "xla":
        raise ValueError(f"unknown impl {spec.impl!r}")
    if spec.impl == "pallas" and z.shape[0] <= GEMV_MAX_ROWS:
        from qpalette_tpu.kernels.trellis_gemv import decode_gemv
        y = decode_gemv(z, p["trellis_kt"], spec.KV[0], spec.mode,
                        spec.out_features, spec.in_features)
    else:
        wt, s = _decode_t(spec, p, luts)
        y = jax.lax.dot_general(z, wt.astype(z.dtype),
                                (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32) * s
    return (y * p["wscale"][None, :].astype(jnp.float32)).astype(odt)
