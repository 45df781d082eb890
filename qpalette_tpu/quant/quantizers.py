"""Scheme-level weight quantizers: TCQ, comb/tcomb (fractional TCQ), VQ/SQ.

Reference behavior:
  - TCQ: lib/quantizer/tcq_quant.py:15-80 (qtip_quantize_mat)
  - comb / tcomb fractional-bit split: lib/quantizer/comb_quant.py
  - VQ-LDLQ: lib/quantizer/vq_quant_ldlq.py:11-65
  - VQ-ALS ("sq_*"/"vq2_*"): lib/quantizer/vq_quant.py + nuq_op.py

All quantizers consume an incoherence-rotated, row-normalized weight Wr and
(optionally) a rotated Hessian, and emit packed codes in the canonical
formats of ops/packing.py.  Everything is jit-compiled per (shape, scheme) — the
trace-time specialization that replaces the reference's per-shape CUDA
codegen (lib/linear/__init__.py:9-420).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from qpalette_tpu.ops import packing
from qpalette_tpu.ops.codebooks import (trellis_lut, trellis_lut_arith,
                                        vq_lut, tlut_bits_for_kv)
from qpalette_tpu.quant.ldlq import block_ldl, ldlq, regularize_h
from qpalette_tpu.quant.viterbi import tcq_quantize

TD = 16


def _ldl_or_zero(H: Optional[jax.Array], n: int, b: int):
    if H is None:
        return jnp.zeros((n, n), jnp.float32)
    Hr = regularize_h(H.astype(jnp.float32))
    L, _ = block_ldl(Hr, b)
    return L.astype(jnp.float32)


def _block_to_seqs(E: jax.Array, kmajor: bool = False) -> jax.Array:
    """(m, 16) column block -> (m/16, 256) tile sequences.

    kmajor=False: p = 16*row + col (V=2 trellis).  kmajor=True:
    p = 16*col + row (V=1 trellis — the order the decode-GEMV kernel
    reads, see ops/packing.dequant_tcq)."""
    m = E.shape[0]
    t = E.reshape(m // TD, TD, TD)
    if kmajor:
        t = t.transpose(0, 2, 1)
    return t.reshape(m // TD, TD * TD)


def _seqs_to_block(hat: jax.Array, m: int, kmajor: bool = False) -> jax.Array:
    t = hat.reshape(m // TD, TD, TD)
    if kmajor:
        t = t.transpose(0, 2, 1)
    return t.reshape(m, TD)


def _block_to_seqs_pairk(E: jax.Array) -> jax.Array:
    """(m, 16) column block -> (m/16, 256) in PAIRED-K-MAJOR order:
    seq position 32*t + 2*row_in_tile + c is weight (row, col=2t+c) —
    trellis state s = 16*t + row covers two k-adjacent weights, the order
    the decode-GEMV kernel reads (kernels/trellis_gemv.py)."""
    m = E.shape[0]
    t = E.reshape(m // TD, TD, TD // 2, 2)  # (tile, row, t, c)
    return t.transpose(0, 2, 1, 3).reshape(m // TD, TD * TD)


def _seqs_to_block_pairk(hat: jax.Array, m: int) -> jax.Array:
    t = hat.reshape(m // TD, TD // 2, TD, 2).transpose(0, 2, 1, 3)
    return t.reshape(m, TD)


def _stack_tile_codes(states: jax.Array, m: int, n: int,
                      v: int = 2) -> jax.Array:
    """ldlq-stacked states (n/16, m/16, 256/v) -> (T, 256/v) row-major."""
    return states.transpose(1, 0, 2).reshape((m // TD) * (n // TD), 256 // v)


@functools.partial(jax.jit, static_argnames=("KV", "use_hess", "v", "beam"))
def _tcq_core(Wr, H, lut, KV: int, use_hess: bool, v: int = 2,
              beam: int = 0):
    m, n = Wr.shape
    kmajor = (v == 1)
    if use_hess:
        Hr = regularize_h(H.astype(jnp.float32))
        L, D = block_ldl(Hr, TD)
        L = L.astype(jnp.float32)
    else:
        L = jnp.zeros((n, n), jnp.float32)
        D = jnp.tile(jnp.eye(TD, dtype=jnp.float32), (n // TD, 1, 1))

    def qblock(E, idx):
        seqs = _block_to_seqs(E, kmajor)
        hat, states = tcq_quantize(seqs, lut, KV, v=v)
        if beam > 0:
            # Hessian-weighted beam refinement of each tile sequence
            # under the residual weight D[idx] (reference
            # ldlq_beam_cd.py:63-70 intent; quant/beam.py)
            from qpalette_tpu.quant.beam import tcq_quantize_beam
            Dc = jnp.take(D, idx, axis=0)
            eye = jnp.eye(TD, dtype=jnp.float32)
            Dt = jnp.kron(Dc, eye) if kmajor else jnp.kron(eye, Dc)
            hat, states = tcq_quantize_beam(seqs, lut, Dt, states, KV,
                                            v=v, beam=beam)
        return _seqs_to_block(hat, m, kmajor), states

    hatW, states = ldlq(Wr, L, qblock, block=TD)
    packed = packing.pack_trellis(_stack_tile_codes(states, m, n, v), KV,
                                  v=v)
    return hatW, packed


@functools.partial(jax.jit, static_argnames=("KV", "use_hess"))
def _tcq2_core(Wr, H, lut, KV: int, use_hess: bool):
    """V=2 trellis in paired-k-major order (the decode-GEMV kernel's)."""
    m, n = Wr.shape
    L = _ldl_or_zero(H if use_hess else None, n, TD)

    def qblock(E, _idx):
        seqs = _block_to_seqs_pairk(E)
        hat, states = tcq_quantize(seqs, lut, KV, v=2)
        return _seqs_to_block_pairk(hat, m), states

    hatW, states = ldlq(Wr, L, qblock, block=TD)
    packed = packing.pack_trellis(_stack_tile_codes(states, m, n, 2), KV,
                                  v=2)
    return hatW, packed


@functools.partial(jax.jit,
                   static_argnames=("KV1", "KV2", "use_hess"))
def _combt_core(Wr, H, lut, KV1: int, KV2: int, use_hess: bool):
    """Input-split fractional TCQ: columns [0, n/2) at KV1 bits, [n/2, n) at
    KV2 bits, single LDLQ recursion switching codebooks at the midpoint
    (reference LDLQ_combt, lib/algo/ldlq.py:128-203)."""
    m, n = Wr.shape
    lut1 = lut2 = lut
    L = _ldl_or_zero(H if use_hess else None, n, TD)
    half_blocks = (n // 2) // TD

    def qblock(E, idx):
        seqs = _block_to_seqs(E)

        def q1(s):
            return tcq_quantize(s, lut1, KV1)

        def q2(s):
            return tcq_quantize(s, lut2, KV2)

        hat, states = jax.lax.cond(idx >= half_blocks, q2, q1, seqs)
        return _seqs_to_block(hat, m), states

    hatW, states = ldlq(Wr, L, qblock, block=TD)
    # split codes at the midpoint and pack each half at its own bitrate
    st = states.reshape(n // TD, m // TD, 128)
    st1 = st[: half_blocks].transpose(1, 0, 2).reshape(-1, 128)
    st2 = st[half_blocks:].transpose(1, 0, 2).reshape(-1, 128)
    p1 = packing.pack_trellis(st1, KV1)
    p2 = packing.pack_trellis(st2, KV2)
    return hatW, p1, p2


@functools.partial(jax.jit, static_argnames=("bits", "vec", "use_hess"))
def _vq_ldlq_core(Wr, H, lut, bits: int, vec: int, use_hess: bool):
    m, n = Wr.shape
    lutf = lut.astype(jnp.float32)
    norms = jnp.sum(lutf * lutf, axis=1)
    L = _ldl_or_zero(H if use_hess else None, n, vec)

    def qblock(E, _idx):
        # E (m, vec): nearest centroid via the cross-term (full f32: the
        # GPU's default f32 matmul is TF32)
        cross = jnp.matmul(E.astype(jnp.float32), lutf.T,
                           precision=jax.lax.Precision.HIGHEST)
        idx = jnp.argmin(norms[None, :] - 2.0 * cross, axis=1)
        hat = jnp.take(lutf, idx, axis=0)
        return hat, idx.astype(jnp.int32)

    hatW, codes = ldlq(Wr, L, qblock, block=vec)
    idxs = codes.T  # (m, n/vec)
    packed = packing.pack_rows(idxs, bits)
    return hatW, packed


# ---------------------------------------------------------------------------
# public API: returns (packed artifact dict, hatWr) — hatWr is the
# dequantized (still-rotated, unit-scale) weight for error reporting.
# ---------------------------------------------------------------------------

def quantize_mat_tcq(Wr, H, KV: int, use_hess: bool = False,
                     beam: int = 0):
    """beam > 0 adds Hessian-weighted beam refinement per tile (the
    reference's ldlq_beam_cd beam branch; slow — quality research)."""
    tlut_bits = tlut_bits_for_kv(KV)
    lut = jnp.asarray(trellis_lut(tlut_bits))
    hatW, packed = _tcq_core(Wr, H if H is not None else Wr[:1, :1] * 0,
                             lut, KV, use_hess and H is not None,
                             beam=beam)
    linear = {
        "kind": "tcq", "KV": KV, "tlut_bits": tlut_bits,
        "trellis": np.asarray(packed),
        "in_features": Wr.shape[1], "out_features": Wr.shape[0],
    }
    return linear, hatW


def quantize_mat_tcq1(Wr, H, KV: int, mode: str = "1mad",
                      use_hess: bool = False, beam: int = 0):
    """V=1 trellis with an arithmetic (gather-free) decoder — reference
    decode modes 1mad/2mad (bitshift.py:16-39, 110-117).  KV bits/weight;
    the decode-GEMV kernel computes the LCG+byte-sum inline (no LUT)."""
    lut = jnp.asarray(trellis_lut_arith(mode))
    hatW, packed = _tcq_core(Wr, H if H is not None else Wr[:1, :1] * 0,
                             lut, KV, use_hess and H is not None, v=1,
                             beam=beam)
    linear = {
        "kind": "tcq1", "KV": KV, "decode_mode": mode,
        "trellis": np.asarray(packed),
        "in_features": Wr.shape[1], "out_features": Wr.shape[0],
    }
    return linear, hatW


def quantize_mat_tcq2(Wr, H, KV: int, use_hess: bool = False,
                      mode: str = "dualmad"):
    """V=2 arithmetic trellis ('tcq2'): KV bits per STATE = KV/2 bits per
    weight (odd KV gives fractional bitrates without comb splits).  Decode
    modes (ops/codebooks.py):
      dualmad — two LCG scrambles per pair, 4 signed bytes per weight;
        one state window per weight pair, at reference quality.
      sum2 ('tcq2s') — one scramble per pair, 2 signed bytes per weight;
        about half the decode work, slightly higher proxy err (the
        latency-constrained point of the palette)."""
    lut = jnp.asarray(trellis_lut_arith(mode))
    hatW, packed = _tcq2_core(Wr, H if H is not None else Wr[:1, :1] * 0,
                              lut, KV, use_hess and H is not None)
    linear = {
        "kind": "tcq2", "KV": KV, "decode_mode": mode,
        "trellis": np.asarray(packed),
        "in_features": Wr.shape[1], "out_features": Wr.shape[0],
    }
    return linear, hatW


def quantize_mat_combt(Wr, H, KV1: int, KV2: int, use_hess: bool = False):
    tlut_bits = tlut_bits_for_kv(max(KV1, KV2))
    lut = jnp.asarray(trellis_lut(tlut_bits))
    hatW, p1, p2 = _combt_core(Wr, H if H is not None else Wr[:1, :1] * 0,
                               lut, KV1, KV2,
                               use_hess and H is not None)
    n = Wr.shape[1]
    linear = {
        "kind": "tcomb", "KV1": KV1, "KV2": KV2, "tlut_bits": tlut_bits,
        "trellis1": np.asarray(p1), "trellis2": np.asarray(p2),
        "in_part": (n // 2, n // 2),
        "in_features": n, "out_features": Wr.shape[0],
    }
    return linear, hatW


def quantize_mat_comb(Wr, H, KV1: int, KV2: int, out_part, use_hess=False):
    """Output-split fractional TCQ (reference comb_quant.py:29-100): rows
    [0, out_part[0]) at KV1 bits, rest at KV2 — two independent TCQ runs."""
    m0 = out_part[0] - out_part[0] % TD
    l1, hat1 = quantize_mat_tcq(Wr[:m0], H, KV1, use_hess)
    l2, hat2 = quantize_mat_tcq(Wr[m0:], H, KV2, use_hess)
    hatW = jnp.concatenate([hat1, hat2], axis=0)
    linear = {
        "kind": "comb", "KV1": KV1, "KV2": KV2,
        "tlut_bits": l1["tlut_bits"],
        "trellis1": l1["trellis"], "trellis2": l2["trellis"],
        "out_part": (m0, Wr.shape[0] - m0),
        "in_features": Wr.shape[1], "out_features": Wr.shape[0],
    }
    return linear, hatW


def quantize_mat_vq(Wr, H, bits: int, vec: int, use_hess: bool = False):
    """VQ/SQ via LDLQ (quantizer_str family ldlq_{vec}_{bits})."""
    lut = jnp.asarray(vq_lut(bits, vec))
    hatW, packed = _vq_ldlq_core(Wr, H if H is not None else Wr[:1, :1] * 0,
                                 lut, bits, vec, use_hess and H is not None)
    linear = {
        "kind": "vq", "bits": bits, "vec": vec,
        "qweight": np.asarray(packed),
        "in_features": Wr.shape[1], "out_features": Wr.shape[0],
    }
    return linear, hatW
