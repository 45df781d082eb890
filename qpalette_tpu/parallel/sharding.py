"""Multi-chip sharding: mesh construction + parameter partition specs.

Reference behavior: the reference is single-GPU; its only distribution
surface is pipeline device_map splitting (lib/utils/unsafe_import.py:43-62)
and vestigial tensor-parallel hooks (`rcp`/`tp_rank` buffers,
lib/linear/quantized_linear.py:42-44, bitshift.py:374-388) that rescope the
Hadamard to per-shard sizes.  This module is the jax.sharding replacement
(SURVEY.md §2.12): a (dp, tp) device mesh with XLA-inserted collectives.

Placement (correct on any mesh): every projection is column-parallel —
packed codes, Wscale and the KV cache shard along output rows / heads,
while incoherence rotations (SU ⊙ x then Hadamard) always see replicated
activations, so the rotation math is untouched by sharding.  XLA inserts
all-gathers where a sharded block output feeds the next replicated
rotation.  The row-parallel alternative (per-shard Hadamard, psum instead
of all-gather) is the shard_map path in parallel/tp.py.

Axes: ("dp", "tp") — batch shards over dp, weights over tp.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_devices or len(devices)
    devices = np.asarray(devices[:n])
    if tp is None:
        tp = n
    dp = n // tp
    return Mesh(devices.reshape(dp, tp), ("dp", "tp"))


def _leaf_pspec(key: str, ndim: int) -> P:
    """PartitionSpec for a param leaf by name (see loader param schema)."""
    if key == "qweight_t":  # (words over k, m)
        return P(None, "tp")
    if key in ("trellis_kt", "trellis1_kt", "trellis2_kt"):
        return P(None, None, "tp")  # (k/16, words, m/16)
    if key == "wscale":
        return P("tp")
    if key == "w":  # dense projection (out, in): column-parallel
        return P("tp", None)
    if key in ("embed", "lm_head"):
        return P("tp", None)
    return P()  # SU, norms, LUTs, tabs: replicated


def param_shardings(params, mesh: Mesh):
    """NamedSharding pytree matching the params structure."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: (NamedSharding(mesh, _leaf_pspec(k, v.ndim))
                        if not isinstance(v, (dict, list)) else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return NamedSharding(mesh, P())

    out = walk(params)
    # top-level non-layer leaves
    for k in ("embed", "lm_head"):
        if k in params:
            out[k] = NamedSharding(mesh, P("tp", None))
    if "ln_f" in params:
        out["ln_f"] = NamedSharding(mesh, P())
    return out


def shard_params(params, mesh: Mesh):
    shardings = param_shardings(params, mesh)
    return jax.tree.map(lambda x, s: jax.device_put(x, s), params,
                        shardings)


def kv_cache_shardings(spec, mesh: Mesh):
    """(B, T, heads_kv, d) caches: batch over dp, heads over tp."""
    s = NamedSharding(mesh, P("dp", None, "tp", None))
    return [(s, s) for _ in range(spec.config.num_layers)]
