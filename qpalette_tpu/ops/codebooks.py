"""Codebook construction: trellis (TCQ) and vector/scalar (VQ/SQ) LUTs.

Reference behavior:
  - trellis codebook ``bitshift_codebook`` with decode_mode='quantlut_sym':
    lib/codebook/bitshift.py:71-79,145-169 — a 2^tlut_bits × 2 k-means
    codebook over N(0,1)² expanded to 2^16 trellis states via the hash
    h = s*(s+1); bit 15 of h flips the sign of component 0 and bits
    [16-tlut_bits-1, 16-1) index the small LUT.
  - VQ codebook: lib/codebook/vq_codebook.py:8-44 — k-means over N(0,1)^vec.

Both are cached on disk under assets/lut_cache (same resumability contract
as reference bitshift.py:148-160 / vq_codebook.py:17-30).

The trellis expansion keeps the reference's exact hash so distortion
characteristics (and therefore the MSQ proxy-error tables) match; the
*packed* format and state-transition convention differ (see ops/packing.py).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax.numpy as jnp

from qpalette_tpu.utils.kmeans import kmeans

L = 16
V = 2

_ASSET_DIR = os.environ.get(
    "QPALETTE_ASSETS",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
                 "assets"))


def tlut_bits_for_kv(kv: int) -> int:
    """Reference rule quantize_layer.py:32-34: KV≤8→9, 9→10, 10→11."""
    if kv <= 8:
        return 9
    return kv + 1


def _cache_path(name: str) -> str:
    d = os.path.join(_ASSET_DIR, "lut_cache")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


@functools.lru_cache(maxsize=None)
def trellis_tlut(tlut_bits: int, n_samples: int = 1 << 20) -> np.ndarray:
    """2^tlut_bits × 2 k-means codebook over N(0,1)², std-normalized.

    Normalization constant 0.9682458365518543 = sqrt(15/16) matches
    reference bitshift.py:156-157.
    """
    path = _cache_path(f"tcq_tlut_{tlut_bits}.npy")
    if os.path.exists(path):
        return np.load(path)
    rng = np.random.default_rng(1234 + tlut_bits)
    data = rng.standard_normal((n_samples, 2)).astype(np.float32)
    c = kmeans(data, 1 << tlut_bits, iters=40, seed=tlut_bits)
    c = c / c.std() * 0.9682458365518543
    c = c.astype(np.float32)
    np.save(path, c)
    return c


@functools.lru_cache(maxsize=None)
def trellis_lut(tlut_bits: int) -> np.ndarray:
    """Expand tlut to the full 2^16-state LUT (quantlut_sym hash)."""
    tlut = trellis_tlut(tlut_bits)
    s = np.arange(1 << L, dtype=np.uint64)
    h = (s + 1) * s
    sflp = 1.0 - ((h >> 15) & 1).astype(np.float32) * 2.0
    idx = (h >> np.uint64(16 - tlut_bits - 1)) & np.uint64((1 << tlut_bits) - 1)
    lut = tlut[idx.astype(np.int64)].copy()
    lut[:, 0] *= sflp
    return lut  # (2^16, 2) float32


@functools.lru_cache(maxsize=None)
def vq_lut(lut_bits: int, vec_sz: int, n_samples: int = 1 << 20) -> np.ndarray:
    """VQ/SQ codebook: k-means over N(0,1)^vec_sz -> (2^lut_bits, vec_sz)."""
    path = _cache_path(f"vq_kmeans_{lut_bits}_{vec_sz}.npy")
    if os.path.exists(path):
        return np.load(path)
    rng = np.random.default_rng(4321 + 64 * lut_bits + vec_sz)
    data = rng.standard_normal((n_samples, vec_sz)).astype(np.float32)
    c = kmeans(data, 1 << lut_bits, iters=40, seed=lut_bits * 7 + vec_sz)
    c = c.astype(np.float32)
    np.save(path, c)
    return c


def lut_rms(lut: np.ndarray) -> float:
    """RMS of codebook values (used for Wscale normalization,
    reference tcq_quant.py:127)."""
    return float(np.sqrt(np.mean(np.asarray(lut, dtype=np.float64) ** 2)))


# ---------------------------------------------------------------------------
# arithmetic (gather-free) trellis decoders — reference bitshift.py:16-59
# ---------------------------------------------------------------------------

MAD1_A, MAD1_B = 34038481, 76625530
MAD2_A, MAD2_B, MAD2_C = 264435761, 1013904223, 1664525
MAD_SCALE = 147.800537109375


def decode_1mad(x: np.ndarray) -> np.ndarray:
    """Pure-ALU Gaussian-ish decoder: one multiply-add + byte-sum.

    Mirrors reference decode_1mad (bitshift.py:16-25); V=1 (one weight per
    trellis state).  Pure integer arithmetic: no codebook lookup."""
    x = np.asarray(x).astype(np.uint64) & 0xFFFFFFFF
    x = (x * MAD1_A + MAD1_B) & 0xFFFFFFFF
    y = ((x & 255) + ((x >> 8) & 255) + ((x >> 16) & 255)
         + ((x >> 24) & 255)).astype(np.float64) - 510.0
    return (y / MAD_SCALE).astype(np.float32)


def decode_dualmad(x: np.ndarray) -> np.ndarray:
    """V=2 arithmetic decoder ('tcq2'): one 16-bit state yields TWO
    weights, each the sum of the four *signed* (int8-reinterpreted) bytes
    of an independent LCG scramble h_i = u * A_i mod 2^32.

    vs reference decode_1mad (bitshift.py:16-25): the decoder derives one
    state window per WEIGHT PAIR instead of per weight.  Proxy err @3
    bits/weight (KV=6): 0.0191 — ties the reference's tcq_6 LUT scheme
    (0.0189).  Returns (len(x), 2) float32.
    """
    u = np.asarray(x).astype(np.uint64) & 0xFFFFFFFF
    out = []
    for A in (MAD1_A, MAD2_A):
        h = (u * A) & 0xFFFFFFFF
        b = np.stack([(h >> (8 * i)) & 255 for i in range(4)],
                     axis=1).astype(np.int64)
        sb = np.where(b >= 128, b - 256, b)
        out.append(sb.sum(axis=1).astype(np.float64))
    return (np.stack(out, axis=1) / MAD_SCALE).astype(np.float32)


def decode_sum2(x: np.ndarray) -> np.ndarray:
    """V=2 arithmetic decoder ('tcq2s'): ONE LCG scramble h = u*A + B per
    weight pair; weight 0 = signed bytes b0+b1, weight 1 = b2+b3.

    vs decode_dualmad: one scramble per pair instead of two, so about half
    the decode work per weight.  The marginal is Irwin-Hall-2
    (triangular) rather than Irwin-Hall-4 (assets/quant_err.json: tcq2s_6
    0.0197 vs tcq_6 0.0189 @3 bits/weight) — the latency-constrained MSQ
    trades exactly this way (reference solve_lat_const.py picks
    lower-quality/faster variants under a latency budget).
    Returns (len(x), 2) float32."""
    u = np.asarray(x).astype(np.uint64) & 0xFFFFFFFF
    h = (u * MAD1_A + MAD1_B) & 0xFFFFFFFF
    b = np.stack([(h >> (8 * i)) & 255 for i in range(4)],
                 axis=1).astype(np.int64)
    sb = np.where(b >= 128, b - 256, b)
    out = np.stack([sb[:, 0] + sb[:, 1], sb[:, 2] + sb[:, 3]], axis=1)
    return (out.astype(np.float64) / MAD_SCALE).astype(np.float32)


def decode_2mad(x: np.ndarray) -> np.ndarray:
    """Two-stage LCG decoder (reference bitshift.py:28-39)."""
    x = np.asarray(x).astype(np.uint64) & 0xFFFFFFFF
    x = (x * MAD2_A + MAD2_B) & 0xFFFFFFFF
    x = (((x * MAD2_C) >> 32) + x) & 0xFFFFFFFF
    y = ((x & 255) + ((x >> 8) & 255) + ((x >> 16) & 255)
         + ((x >> 24) & 255)).astype(np.float64) - 510.0
    return (y / MAD_SCALE).astype(np.float32)


MAD3_A, MAD3_B, MAD3_FPMASK = 89226354, 64248484, 996162400


def decode_3inst(x: np.ndarray) -> np.ndarray:
    """fp16 bit-trick decoder (reference bitshift.py:42-59): LCG scramble,
    mask sign+low-exponent+mantissa of each 16-bit half, XOR a constant
    exponent pattern, and sum the two resulting fp16s."""
    u = (np.asarray(x).astype(np.uint64) * MAD3_A + MAD3_B) & 0xFFFFFFFF
    mask = ((1 << 15) + ((1 << 12) - 1))
    mask = (mask << 16) + mask
    res = (u & mask) ^ MAD3_FPMASK
    top = (res >> 16).astype(np.uint16).view(np.float16)
    bottom = (res & 0xFFFF).astype(np.uint16).view(np.float16)
    return (top.astype(np.float32) + bottom.astype(np.float32))


@functools.lru_cache(maxsize=None)
def trellis_lut_arith(mode: str) -> np.ndarray:
    """State->value table for the arithmetic decode modes: (2^16, 1) for
    the V=1 modes (1mad / 2mad), (2^16, 2) for dualmad (V=2 — two weights
    per state).  Used by the Viterbi encoder and the spec decoders; the
    decode-GEMV kernel computes the same function inline."""
    s = np.arange(1 << L, dtype=np.uint64)
    if mode == "1mad":
        v = decode_1mad(s)
    elif mode == "2mad":
        v = decode_2mad(s)
    elif mode == "3inst":
        v = decode_3inst(s)
    elif mode == "dualmad":
        return decode_dualmad(s)  # (2^16, 2) — V=2
    elif mode == "sum2":
        return decode_sum2(s)  # (2^16, 2) — V=2, halved kernel feed
    else:
        raise ValueError(mode)
    return v[:, None].astype(np.float32)
