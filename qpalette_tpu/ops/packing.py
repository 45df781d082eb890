"""Packed weight formats for SQ/VQ/TCQ + executable reference codecs.

Reference behavior being re-specified (NOT ported):
  - SQ/VQ tensor-core bit-plane swizzle: lib/quantizer/quant_op.py:89-162
  - TCQ trellis uint16 bitstream + mma nibble swizzle:
    lib/codebook/bitshift.py:296-329 and lib/quantizer/tcq_quant.py:46-60
  - executable decode spec: lib/utils/kernel_decompress.py:18-61

Design
------
The reference layouts are artifacts of CUDA mma fragment ownership.  Here
the canonical formats are plain little-endian bitstreams with *static*
window-extraction tables (computed at trace time):
every packed index/state lives at a compile-time-known (word, shift), so the
decode is a constant-index gather + two shifts + or + mask — fully
vectorized, no data-dependent control flow.

SQ/VQ format ("rowpack"):
  indices[m, P] with `bits` bits each (P = k / vec_sz) are concatenated
  LSB-first into a per-row bitstream, stored as uint32 words little-endian
  within each word, one trailing zero pad word per row:
    packed[m, ceil(P*bits/32) + 1] uint32
  Index i is stream bits [i*bits, (i+1)*bits).

TCQ format ("trellispack"):
  Weights are tiled (16, 16); each tile is one tail-biting trellis sequence
  of 128 states (V=2 weights per state, row-major within the tile).  The
  trellis convention is  s_{i+1} = (s_i >> KV) | (new_bits << (L-KV))  so a
  state is exactly the 16-bit window at stream offset i*KV of a *circular*
  bitstream of 128*KV bits = 4*KV uint32 words per tile:
    packed[n_tiles, 4*KV] uint32,  n_tiles = (m/16)*(k/16), tile-row-major.
  Tail-biting (s_127 >> KV == s_0 & mask(L-KV)) makes every tile
  self-contained — the property the Pallas kernel relies on to decode tiles
  independently (reference achieves this via bitshift.py:285-294 overlap
  re-encoding).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

L = 16  # trellis window length (bits per state), fixed as in reference
TD = 16  # weight tile edge (td_x = td_y = 16)
V = 2  # weights per trellis state

__all__ = [
    "pack_rows", "unpack_rows", "pack_trellis", "unpack_trellis",
    "dequant_lut", "dequant_tcq", "tiles_to_mat", "mat_to_tiles",
]


# ---------------------------------------------------------------------------
# generic bit packing
# ---------------------------------------------------------------------------

def _bits_to_words(bits: jax.Array) -> jax.Array:
    """bits[..., 32*w] (0/1) -> uint32 words[..., w], little-endian."""
    n = bits.shape[-1]
    assert n % 32 == 0
    b = bits.astype(jnp.uint32).reshape(bits.shape[:-1] + (n // 32, 32))
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def pack_rows(indices: jax.Array, bits: int) -> jax.Array:
    """Pack LUT indices into the rowpack format (see module docstring)."""
    m, P = indices.shape
    idx = indices.astype(jnp.uint32)
    shifts = jnp.arange(bits, dtype=jnp.uint32)
    bitmat = ((idx[:, :, None] >> shifts) & 1).reshape(m, P * bits)
    nb = P * bits
    nwords = -(-nb // 32)
    pad = nwords * 32 - nb
    if pad:
        bitmat = jnp.pad(bitmat, ((0, 0), (0, pad)))
    words = _bits_to_words(bitmat)
    return jnp.pad(words, ((0, 0), (0, 1)))  # trailing pad word for windows


@functools.lru_cache(maxsize=None)
def _window_tables(n_pos: int, stride_bits: int, n_words: int,
                   modular: bool) -> tuple[np.ndarray, np.ndarray]:
    """Static (word index, shift) for 32-bit windows at offsets i*stride."""
    o = np.arange(n_pos, dtype=np.int64) * stride_bits
    w0 = (o >> 5).astype(np.int32)
    sh = (o & 31).astype(np.int32)
    w1 = w0 + 1
    if modular:
        w0 %= n_words
        w1 %= n_words
    return w0, sh, w1


def _extract_windows(words: jax.Array, n_pos: int, stride_bits: int,
                     out_bits: int, modular: bool) -> jax.Array:
    """words[..., W] uint32 -> values[..., n_pos]; window i at bit i*stride."""
    W = words.shape[-1]
    w0, sh, w1 = _window_tables(n_pos, stride_bits, W, modular)
    lo = words[..., w0]
    hi = words[..., w1]
    shv = jnp.asarray(sh, dtype=jnp.uint32)
    # (hi << (32 - sh)) with sh == 0 well-defined via two-step shift
    win = (lo >> shv) | ((hi << (31 - shv)) << 1)
    return (win & jnp.uint32((1 << out_bits) - 1)).astype(jnp.int32)


def unpack_rows(packed: jax.Array, bits: int, n_idx: int) -> jax.Array:
    """Inverse of pack_rows -> int32 indices[m, n_idx]."""
    return _extract_windows(packed, n_idx, bits, bits, modular=False)


# ---------------------------------------------------------------------------
# trellis packing
# ---------------------------------------------------------------------------

def pack_trellis(states: jax.Array, KV: int, v: int = V) -> jax.Array:
    """states[T, 256//v] (int, < 2^16) -> packed[T, 8*KV//v] uint32.

    Requires the tail-biting property s_{i+1} == (s_i >> KV) | (new << L-KV)
    wrapping at the end; only the *new* top KV bits of each state after the
    first are stored.  v = weights per state (2 for quantlut_sym, 1 for the
    arithmetic decode modes).
    """
    T, S = states.shape
    assert S == 256 // v
    s = states.astype(jnp.uint32)
    shifts16 = jnp.arange(L, dtype=jnp.uint32)
    first = (s[:, :1] >> shifts16[None, :]) & 1  # (T, 16)
    shiftsk = jnp.arange(KV, dtype=jnp.uint32)
    new = ((s[:, 1:, None] >> (L - KV)) >> shiftsk) & 1  # (T, 127, KV)
    bitmat = jnp.concatenate([first, new.reshape(T, (S - 1) * KV)], axis=1)
    # total bits = 16 + 127*KV = 128*KV + (16 - KV); the trailing (16 - KV)
    # bits duplicate the first (16 - KV) bits (tail-biting) — drop them.
    bitmat = bitmat[:, : S * KV]
    return _bits_to_words(bitmat)


def unpack_trellis(packed: jax.Array, KV: int, v: int = V) -> jax.Array:
    """packed[T, 8*KV//v] uint32 -> states[T, 256//v] int32 (circular)."""
    return _extract_windows(packed, 256 // v, KV, L, modular=True)


# ---------------------------------------------------------------------------
# tile <-> matrix layout
# ---------------------------------------------------------------------------

def tiles_to_mat(tiles: jax.Array, m: int, k: int) -> jax.Array:
    """tiles[(m/16)*(k/16), 16, 16] (tile-row-major) -> mat[m, k]."""
    t = tiles.reshape(m // TD, k // TD, TD, TD)
    return t.transpose(0, 2, 1, 3).reshape(m, k)


def mat_to_tiles(mat: jax.Array) -> jax.Array:
    """mat[m, k] -> tiles[(m/16)*(k/16), 16, 16]."""
    m, k = mat.shape
    t = mat.reshape(m // TD, TD, k // TD, TD).transpose(0, 2, 1, 3)
    return t.reshape(-1, TD, TD)


# ---------------------------------------------------------------------------
# reference dequantizers (executable spec; XLA path, also the bs>8 fallback)
# ---------------------------------------------------------------------------

def dequant_lut(packed: jax.Array, lut: jax.Array, m: int, k: int,
                bits: int, vec_sz: int) -> jax.Array:
    """SQ/VQ dequant: rowpack indices -> weights[m, k] (lut[2^bits, vec])."""
    P = k // vec_sz
    idx = unpack_rows(packed, bits, P)  # (m, P)
    w = jnp.take(lut, idx, axis=0)  # (m, P, vec)
    return w.reshape(m, k)


def dequant_tcq(packed: jax.Array, lut: jax.Array, m: int, k: int,
                KV: int, v: int = V) -> jax.Array:
    """TCQ dequant: trellispack -> weights[m, k] (lut[2^L, v] expanded).

    Within-tile sequence order: v=2 is m-major (p = 16*row + col, V=2
    weights per state); v=1 is K-MAJOR (p = 16*col + row) — chosen so the
    decode-GEMV kernel (kernels/trellis_gemv.py) maps
    bitstream-consecutive states to one k-column of the tile."""
    states = unpack_trellis(packed, KV, v)  # (T, 256//v)
    vals = jnp.take(lut, states, axis=0)  # (T, 256//v, v)
    tiles = vals.reshape(-1, TD, TD)
    if v == 1:
        tiles = tiles.transpose(0, 2, 1)  # k-major: p = 16*col + row
    return tiles_to_mat(tiles, m, k)


def dequant_tcq2(packed: jax.Array, lut: jax.Array, m: int, k: int,
                 KV: int) -> jax.Array:
    """tcq2 dequant (executable spec): V=2 trellis in PAIRED-K-MAJOR order —
    state s = 16*t + row covers weights (row, col=2t) and (row, col=2t+1)
    of its 16x16 tile (quantizers._block_to_seqs_pairk; the order the
    decode-GEMV kernel decodes)."""
    states = unpack_trellis(packed, KV, 2)  # (T, 128)
    vals = jnp.take(lut, states, axis=0)  # (T, 128, 2)
    tiles = vals.reshape(-1, TD // 2, TD, 2)  # (T, t, row, c)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(-1, TD, TD)
    return tiles_to_mat(tiles, m, k)
