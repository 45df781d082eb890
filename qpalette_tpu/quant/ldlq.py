"""Block-LDL decomposition + LDLQ feedback quantization.

Reference behavior:
  - block_LDL: lib/utils/math_utils.py:14-43 (Cholesky → block-normalized L)
  - LDLQ / LDLQ_VQ / LDLQ_combt: lib/algo/ldlq.py — iterate column blocks
    right-to-left, quantize W + (W - Ŵ)·L per block, with a 128-column
    buffer level ("prod_cache") to keep the matmuls large.

Design: the two-level buffering becomes two nested lax.scan's
(outer over 128-column buffers with one (m,n)@(n,128) matmul each,
inner over per-block steps with small in-buffer matmuls).  reverse=True
scans keep code order natural.  The quantize callback is a pluggable
function so TCQ (Viterbi), VQ and SQ reuse the same recursion — replacing
the reference's three near-identical copies of LDLQ.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["block_ldl", "ldlq", "regularize_h"]

# every f32 product here needs full f32: the GPU's default is TF32
_HI = jax.lax.Precision.HIGHEST


def regularize_h(H: jax.Array, sigma_reg: float = 0.01) -> jax.Array:
    """Mirror of reference regularize_H (math_utils.py:46-51)."""
    n = H.shape[0]
    diagmean = jnp.mean(jnp.diagonal(H))
    Hn = H / diagmean
    Hn = Hn + sigma_reg * jnp.eye(n, dtype=H.dtype)
    return Hn * diagmean


def _cholesky_damped(H: jax.Array) -> jax.Array:
    """Cholesky with escalating diagonal dampening on failure.

    Near-singular calibration Hessians make plain Cholesky return NaNs
    (reference math_utils.py:19-23 returns None; nuq_op.py:298-314 retries
    with growing dampening).  A lax.while_loop retries only when needed so
    the PD common case pays one factorization."""
    n = H.shape[0]
    diagmean = jnp.mean(jnp.diagonal(H))
    eye = jnp.eye(n, dtype=H.dtype)
    sigmas = jnp.asarray([1e-4, 1e-3, 1e-2, 1e-1, 1.0], H.dtype)

    def cond(state):
        C, i = state
        return jnp.isnan(jnp.sum(C)) & (i < sigmas.shape[0])

    def body(state):
        _, i = state
        return (jnp.linalg.cholesky(H + sigmas[i] * diagmean * eye), i + 1)

    C, _ = jax.lax.while_loop(cond, body,
                              (jnp.linalg.cholesky(H), jnp.int32(0)))
    return C


def block_ldl(H: jax.Array, b: int):
    """H = L D Lᵀ with unit block-diagonal L; returns (L_strict, D).

    L_strict has its diagonal b×b blocks zeroed (ready for LDLQ feedback,
    cf. reference tcq_quant.py:24-31 `LRr[diag, diag] = 0`).
    """
    n = H.shape[0]
    assert n % b == 0
    m = n // b
    C = _cholesky_damped(H)  # lower, (n, n)
    # diagonal b×b blocks of C
    Cb = C.reshape(m, b, m, b)
    DL = Cb[jnp.arange(m), :, jnp.arange(m), :]  # (m, b, b), lower-tri
    D = jnp.matmul(DL, DL.transpose(0, 2, 1), precision=_HI)
    DLinv = jnp.linalg.inv(DL)
    # right-multiply each block column by DLinv
    Lb = jnp.einsum("rmb,mbc->rmc", C.reshape(n, m, b), DLinv,
                    precision=_HI)
    L = Lb.reshape(n, n)
    # zero the diagonal blocks (strictly block-lower)
    blk = jax.lax.broadcasted_iota(jnp.int32, (m, 1, m, 1), 0)
    blk2 = jax.lax.broadcasted_iota(jnp.int32, (m, 1, m, 1), 2)
    mask = (blk != blk2).astype(L.dtype)
    L = (L.reshape(m, b, m, b) * mask).reshape(n, n)
    return L, D


def ldlq(W: jax.Array, Lmat: jax.Array,
         quant_block: Callable[[jax.Array, jax.Array], tuple],
         block: int, buf: int = 128):
    """LDLQ recursion.

    W (m, n), Lmat (n, n) strictly block-lower (block size divides `block`).
    quant_block(vals (m, block), col_block_index) -> (hat (m, block), codes).
    Returns (hatW (m, n), codes stacked (n // block, ...)) where codes[j]
    corresponds to columns [j*block, (j+1)*block).
    """
    m, n = W.shape
    buf = min(buf, n)
    assert n % buf == 0 and buf % block == 0
    nbufs = n // buf
    steps = buf // block
    W = W.astype(jnp.float32)
    Lmat = Lmat.astype(jnp.float32)

    def inner(carry, idx):
        hat_buf, Wbuf, prod, base_idx = carry
        j = idx
        sl = j * block
        Lcol = jax.lax.dynamic_slice(Lbuf_ref[0], (0, sl), (buf, block))
        E = (jax.lax.dynamic_slice(Wbuf, (0, sl), (m, block))
             + jax.lax.dynamic_slice(prod, (0, sl), (m, block))
             + jnp.matmul(Wbuf - hat_buf, Lcol, precision=_HI))
        hat_blk, codes = quant_block(E, base_idx + j)
        hat_buf = jax.lax.dynamic_update_slice(hat_buf, hat_blk, (0, sl))
        return (hat_buf, Wbuf, prod, base_idx), codes

    # We need Lbuf visible inside inner; restructure with a closure per buffer.
    def outer(carry, bidx):
        hatW, = carry
        c0 = bidx * buf
        Wbuf = jax.lax.dynamic_slice(W, (0, c0), (m, buf))
        Lcols = jax.lax.dynamic_slice(Lmat, (0, c0), (n, buf))
        # cross-buffer feedback: only columns outside this buffer contribute
        # (rows inside the buffer are handled by the inner recursion; their
        # hatW entries are stale zeros/garbage but their L rows are used —
        # so zero the in-buffer rows of Lcols for the cross term).
        row_ids = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
        outside = (row_ids < c0) | (row_ids >= c0 + buf)
        Lcross = jnp.where(outside, Lcols, 0.0)
        prod = jnp.matmul(W - hatW, Lcross, precision=_HI)  # (m, buf)
        Lbuf = jax.lax.dynamic_slice(Lcols, (c0, 0), (buf, buf))
        Lbuf_ref[0] = Lbuf

        hat_buf = jnp.zeros((m, buf), jnp.float32)
        (hat_buf, _, _, _), codes = jax.lax.scan(
            inner, (hat_buf, Wbuf, prod, bidx * steps),
            jnp.arange(steps), reverse=True)
        hatW = jax.lax.dynamic_update_slice(hatW, hat_buf, (0, c0))
        return (hatW,), codes

    # scan hack: Lbuf is carried via a mutable cell captured by `inner`;
    # since both scans are traced together this is trace-safe (the value is
    # a traced array defined before the inner scan is traced).
    Lbuf_ref = [None]
    hatW0 = jnp.zeros((m, n), jnp.float32)
    (hatW,), codes = jax.lax.scan(outer, (hatW0,),
                                  jnp.arange(nbufs), reverse=True)
    # codes: (nbufs, steps, ...) -> (n // block, ...)
    codes = jax.tree.map(
        lambda c: c.reshape((nbufs * steps,) + c.shape[2:]), codes)
    return hatW, codes
