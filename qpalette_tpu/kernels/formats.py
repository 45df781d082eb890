"""On-device packed layouts, one per kind.

The canonical formats (ops/packing.py) are row-major bitstreams: trellis
tiles in tile-row-major order, VQ indices as one bitstream per output row.
At load time each kind is placed in the single layout that every consumer
reads — the decode-GEMV kernel, the plain XLA path, the dummy-weight
builder, the memory model and tensor-parallel sharding:

trellis kinds (tcq, tcq1, tcq2 and the halves of tcomb/comb):
  ``trellis_kt`` (k/16, words_per_tile, m/16) uint32 — the canonical
  (m/16 * k/16, words) array with its two tile axes split and the m-tile
  axis moved last.  Consecutive m-tiles sit side by side, so a GPU program
  that owns a block of m-tiles reads each packed word row with one
  coalesced load, and a column-parallel shard is a contiguous m-tile range.
  Every tile's bitstream is self-contained (tail-biting), so row-parallel
  shards split cleanly on k-tiles.  Storage is exactly the nominal bits.

VQ/SQ:
  ``qweight_t`` (P*bits/32, m) uint32 — the rowpack words without the pad
  word, transposed so output rows are the minor axis.  Requires
  P*bits % 32 == 0 (true for every model width); row-parallel shards split
  the word axis when (k/tp/vec*bits) % 32 == 0.

These converters run once at model load.
"""

from __future__ import annotations

import jax.numpy as jnp


def trellis_words_per_tile(KV: int, V: int) -> int:
    """uint32 words per 16x16 tile: 256/V states advancing KV bits each."""
    return 8 * KV // V


def trellis_kt(trellis, m: int, k: int):
    """canonical (m/16 * k/16, W) tile-row-major -> (k/16, W, m/16)."""
    T, W = trellis.shape
    mt, kt = m // 16, k // 16
    assert T == mt * kt, (T, m, k)
    return jnp.asarray(trellis).reshape(mt, kt, W).transpose(1, 2, 0)


def vq_words(packed, bits: int, vec: int, k: int):
    """rowpack (m, P*bits/32 + 1) -> qweight_t (P*bits/32, m)."""
    P = k // vec
    assert (P * bits) % 32 == 0, (P, bits)
    return jnp.asarray(packed)[:, :P * bits // 32].T
