"""Decode-GEMV for the arithmetic trellis formats (tcq1, tcq2), for Hopper.

Reference behavior: the bs<=8 TCQ kernel of the original
(kernels/tcq-kernels/src/inference.cu:408-637) streams the packed trellis
once, stitches each state window in registers and decodes it before the
multiply.  The arithmetic decoders here (1mad / 2mad for V=1, dualmad /
sum2 for V=2; ops/codebooks.decode_*) need no codebook: a state is an LCG
scramble and a byte sum, so the whole decode is 32-bit integer arithmetic.

Design (Pallas through Triton):
  * One program owns ``bm`` consecutive m-tiles (16*bm output rows) and one
    of ``ks`` contiguous k-tile ranges.  It walks its k-tiles in a loop;
    the ``ks`` partial sums go to separate output slices and are added by
    XLA afterwards (no output block is carried between programs).
  * Per k-tile the program gathers, for every state of its tiles, the two
    packed words its 16-bit window straddles from the (k/16, words, m/16)
    layout (kernels/formats.py) — each gathered row is ``bm`` consecutive
    words, one coalesced load — and shifts the window out in registers.
  * The scramble and byte sum give each weight as a small biased integer,
    which becomes a float by or-ing it into the mantissa of 2^23 (one
    logic op and one add, no int-to-float convert).
  * Rows are handled by FMAs against the f32 activation, with f32
    accumulation: no padding to a 16-row dot.  At decode row counts the
    GEMV is bound by the integer decode, not by the multiply (on an H100
    it beats the decode-then-matmul path up to 16 rows; PERF.md).  The
    1/147.8 decode scale is applied after the k-split sum, the per-row
    Wscale by the caller.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from qpalette_tpu.ops.codebooks import (MAD1_A, MAD1_B, MAD2_A, MAD2_B,
                                        MAD2_C, MAD_SCALE)

MAD_INV = 1.0 / MAD_SCALE
MODES = ("1mad", "2mad", "dualmad", "sum2")
_F32_2P23 = 0x4B000000  # bit pattern of 2.0**23


def mode_v(mode: str) -> int:
    """Weights per trellis state: 1 for 1mad/2mad, 2 for dualmad/sum2."""
    assert mode in MODES, mode
    return 1 if mode in ("1mad", "2mad") else 2


def _byte_sum4(h):
    t2 = (h & jnp.uint32(0x00FF00FF)) + ((h >> jnp.uint32(8))
                                         & jnp.uint32(0x00FF00FF))
    return (t2 + (t2 >> jnp.uint32(16))) & jnp.uint32(0x7FF)


def _hi32_mul_add(h, c: int):
    """h + hi32(h * c) in uint32 arithmetic (16-bit limbs, exact)."""
    ch, cl = jnp.uint32(c >> 16), jnp.uint32(c & 0xFFFF)
    xl, xh = h & jnp.uint32(0xFFFF), h >> jnp.uint32(16)
    lowc = (xl * cl) >> jnp.uint32(16)
    mid = xl * ch + xh * cl
    return h + xh * ch + ((mid + lowc) >> jnp.uint32(16))


def arith_sums(u, mode: str):
    """16-bit states (uint32) -> (sums, bias): one uint32 array per weight
    of the state, each holding a non-negative integer below 2^11 such that
    the decoded weight is (sum - bias) / MAD_SCALE (ops/codebooks.decode_*).
    Signed bytes are summed as unsigned bytes of h ^ 0x80808080."""
    flip = jnp.uint32(0x80808080)
    if mode == "1mad":
        return (_byte_sum4(u * jnp.uint32(MAD1_A) + jnp.uint32(MAD1_B)),), 510
    if mode == "2mad":
        h = u * jnp.uint32(MAD2_A) + jnp.uint32(MAD2_B)
        return (_byte_sum4(_hi32_mul_add(h, MAD2_C)),), 510
    if mode == "dualmad":
        return tuple(_byte_sum4((u * jnp.uint32(a)) ^ flip)
                     for a in (MAD1_A, MAD2_A)), 512
    assert mode == "sum2", mode
    g = (u * jnp.uint32(MAD1_A) + jnp.uint32(MAD1_B)) ^ flip
    t2 = (g & jnp.uint32(0x00FF00FF)) + ((g >> jnp.uint32(8))
                                         & jnp.uint32(0x00FF00FF))
    return (t2 & jnp.uint32(0x3FF), t2 >> jnp.uint32(16)), 256


def state_windows(lo, hi, sh):
    """16-bit window at bit `sh` of the 64-bit word pair (hi:lo)."""
    return ((lo >> sh) | ((hi << (jnp.uint32(31) - sh)) << jnp.uint32(1))
            ) & jnp.uint32(0xFFFF)


def state_word_index(KV: int, V: int):
    """(T, 16) int32 arrays (first word, next word, shift) of state
    s = 16*a + r of a tile, a < T = 16/V, r = m-row in the tile."""
    T = 16 // V
    W = 8 * KV // V
    a = jax.lax.broadcasted_iota(jnp.int32, (T, 16), 0)
    r = jax.lax.broadcasted_iota(jnp.int32, (T, 16), 1)
    off = (a * 16 + r) * KV
    j0 = off >> 5
    return j0, (j0 + 1) % W, (off & 31).astype(jnp.uint32)


def interpret_requested() -> bool:
    """Whether to run the Pallas interpreter.  Only an explicit request
    (QPALETTE_INTERPRET=1, set by the CPU test suite) turns it on, and only
    off the GPU: the kernel never falls back silently."""
    want = os.environ.get("QPALETTE_INTERPRET", "0") == "1"
    backend = jax.default_backend()
    if backend == "gpu":
        if want:
            raise RuntimeError("QPALETTE_INTERPRET=1 on a GPU backend: the "
                               "decode-GEMV kernel compiles for the card")
        return False
    if not want:
        raise RuntimeError(
            f"the decode-GEMV kernel has no compiled route on backend "
            f"{backend!r}; use impl='xla', or set QPALETTE_INTERPRET=1 to "
            f"run it in the Pallas interpreter")
    return True


def _gemv_kernel(x_ref, tr_ref, o_ref, *, mode, KV, n_rows, bm, kchunk,
                 kt_total):
    V = mode_v(mode)
    col0 = pl.program_id(0) * bm
    ksel = pl.program_id(1)
    j0, j1, sh = state_word_index(KV, V)
    sh = sh[:, :, None]
    cols = pl.ds(col0, bm)

    def body(kt, accs):
        lo = tr_ref[kt, j0, cols]  # (T, 16, bm): gathered word rows
        hi = tr_ref[kt, j1, cols]
        sums, bias = arith_sums(state_windows(lo, hi, sh), mode)
        accs = list(accs)
        for c, s in enumerate(sums):
            w = (jax.lax.bitcast_convert_type(s | jnp.uint32(_F32_2P23),
                                              jnp.float32)
                 - jnp.float32(8388608.0 + bias))
            for n in range(n_rows):
                xv = x_ref[n, kt, c]  # (T,) activation of the tile's k-cols
                accs[n] = accs[n] + jnp.sum(w * xv[:, None, None], axis=0)
        return tuple(accs)

    start = ksel * kchunk
    stop = jnp.minimum(start + kchunk, kt_total)
    zero = jnp.zeros((16, bm), jnp.float32)
    accs = jax.lax.fori_loop(start, stop, body, (zero,) * n_rows)
    for n in range(n_rows):
        # (m-row in tile, tile) -> natural m order
        o_ref[ksel, n, pl.ds(col0 * 16, 16 * bm)] = accs[n].T.reshape(-1)


def _pow2_divisor(n: int, cap: int) -> int:
    b = 1
    while b * 2 <= cap and n % (b * 2) == 0:
        b *= 2
    return b


def block_config(m: int, k: int, bm: int = 0, ks: int = 0,
                 programs: int = 528):
    """(bm, ks): m-tiles per program (largest power of two <= 32 dividing
    m/16) and the k-split that puts about `programs` programs (4 per SM
    of an H100) on the card."""
    mt, kt = m // 16, k // 16
    bm = bm or _pow2_divisor(mt, 32)
    assert mt % bm == 0 and bm & (bm - 1) == 0, (mt, bm)
    ks = ks or max(1, min(kt, -(-programs // (mt // bm))))
    return bm, ks


def decode_gemv(x, tr_kt, KV: int, mode: str, m: int, k: int, bm: int = 0,
                ks: int = 0, num_warps: int = 4):
    """x (N, k) -> (N, m) f32 = x @ dequant(tr_kt)^T, unscaled by Wscale.

    tr_kt: (k/16, 8*KV/V, m/16) uint32 (formats.trellis_kt).  N is any
    small row count (decode batches); every row is an FMA stream.  The
    interpreter decision is taken on every call, outside the jit cache."""
    return _decode_gemv(x, tr_kt, KV, mode, m, k, bm, ks, num_warps,
                        interpret_requested())


@functools.partial(jax.jit, static_argnums=range(2, 10))
def _decode_gemv(x, tr_kt, KV, mode, m, k, bm, ks, num_warps, interpret):
    V = mode_v(mode)
    T = 16 // V
    N = x.shape[0]
    kt_total = k // 16
    assert tr_kt.shape == (kt_total, 8 * KV // V, m // 16), tr_kt.shape
    bm, ks = block_config(m, k, bm, ks)
    kchunk = -(-kt_total // ks)
    # activation column 16*kt + V*a + c feeds weight c of state row a
    xs = x.astype(jnp.float32).reshape(N, kt_total, T, V).transpose(
        0, 1, 3, 2)
    part = pl.pallas_call(
        functools.partial(_gemv_kernel, mode=mode, KV=KV, n_rows=N, bm=bm,
                          kchunk=kchunk, kt_total=kt_total),
        out_shape=jax.ShapeDtypeStruct((ks, N, m), jnp.float32),
        grid=(m // 16 // bm, ks),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=2),
        interpret=interpret,
        name=f"trellis_gemv_{mode}",
    )(xs, tr_kt)
    return part.sum(axis=0) * jnp.float32(MAD_INV)
