"""K-means used for codebook construction (reference: lib/utils/kmeans.py).

Pure-JAX Lloyd iterations with k-means++-style seeding via quantiles/random
choice; runs on any JAX backend.  Deterministic given the seed.

1-D inputs use the EXACT DP solver (native/kmeans1d.cpp — the equivalent
of the reference's flash1dkmeans exact scalar clustering,
lib/quantizer/vq_quant.py:12-33): optimal 1-D clusters are contiguous in
sorted order, so an O(k·n·log n) divide-and-conquer DP finds the global
optimum.  Falls back to quantile-seeded Lloyd's when the native library
can't be built.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np

_K1D = None
_K1D_TRIED = False


def _kmeans1d_lib():
    global _K1D, _K1D_TRIED
    if _K1D_TRIED:
        return _K1D
    _K1D_TRIED = True
    from qpalette_tpu.ops.native_pack import native_library
    lib = native_library()
    if lib is None:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    lib.qpt_kmeans1d.argtypes = [dp, dp, ctypes.c_int64, ctypes.c_int, dp]
    lib.qpt_kmeans1d.restype = ctypes.c_double
    _K1D = lib
    return _K1D


def kmeans1d_exact(x: np.ndarray, k: int,
                   max_bins: int = 1 << 16) -> np.ndarray | None:
    """Exact (DP) 1-D k-means centroids, sorted ascending; None if the
    native library isn't available.  Samples beyond max_bins are
    aggregated into equal-count weighted bins first (DP memory is
    O(k·n))."""
    lib = _kmeans1d_lib()
    if lib is None:
        return None
    xs = np.sort(np.asarray(x, np.float64).reshape(-1))
    n = xs.shape[0]
    if n > max_bins:
        nb = max_bins
        edges = (n * np.arange(nb + 1)) // nb
        cnt = np.diff(edges).astype(np.float64)
        cs = np.concatenate([[0.0], np.cumsum(xs)])
        vals = (cs[edges[1:]] - cs[edges[:-1]]) / cnt
        xs, w = np.ascontiguousarray(vals), np.ascontiguousarray(cnt)
    else:
        w = None
    out = np.empty((k,), np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.qpt_kmeans1d(
        xs.ctypes.data_as(dp),
        w.ctypes.data_as(dp) if w is not None else None,
        xs.shape[0], k, out.ctypes.data_as(dp))
    return out.astype(np.float32)


def _assign(x: jax.Array, c: jax.Array) -> jax.Array:
    # x (N, d), c (K, d) -> nearest centroid index (N,)
    x2 = jnp.sum(x * x, axis=1, keepdims=True)
    c2 = jnp.sum(c * c, axis=1)[None, :]
    d = x2 + c2 - 2.0 * (x @ c.T)
    return jnp.argmin(d, axis=1)


def kmeans(x: np.ndarray | jax.Array, k: int, iters: int = 40,
           seed: int = 0) -> np.ndarray:
    """Lloyd's k-means; returns centroids sorted for determinism (K, d)."""
    x = jnp.asarray(x, dtype=jnp.float32)
    n, d = x.shape
    if d == 1:
        exact = kmeans1d_exact(np.asarray(x[:, 0]), k)
        if exact is not None:
            return exact[:, None]
        # quantile init: near-optimal for 1-D Gaussian codebooks
        qs = (jnp.arange(k, dtype=jnp.float32) + 0.5) / k
        c = jnp.quantile(x[:, 0], qs)[:, None]
    else:
        key = jax.random.PRNGKey(seed)
        idx = jax.random.choice(key, n, (k,), replace=False)
        c = x[idx]

    @jax.jit
    def step(c):
        a = _assign(x, c)
        one = jnp.ones((n,), jnp.float32)
        cnt = jnp.zeros((k,), jnp.float32).at[a].add(one)
        s = jnp.zeros((k, d), jnp.float32).at[a].add(x)
        newc = s / jnp.maximum(cnt, 1.0)[:, None]
        return jnp.where(cnt[:, None] > 0, newc, c)

    for _ in range(iters):
        c = step(c)
    c = np.asarray(c)
    order = np.lexsort(c.T[::-1])
    return c[order]
