"""Data-dependent VQ ("sq_*" / "vq2_*" quantizer families): full ALS.

Reference behavior: lib/quantizer/vq_quant.py:12-78 (simple_vq: k-means on
the actual rotated weights) + lib/quantizer/nuq_op.py:84-365
(train_least_squares): alternating
  update_P — exhaustive coordinate descent over assignment positions under
             the FULL off-diagonal Hessian objective tr((Ŵ-W) H (Ŵ-W)ᵀ)
  update_C — closed-form least-squares centroid solve (normal equations)
with Hessian PD-dampening retries (nuq_op.py:298-314).

Design (not a port): update_P is one lax.scan over positions
carrying the residual Δ = Ŵ-W and its Hessian image S = Δ·H — choosing a
centroid at position j is then a rank-`vec` update, and the per-position
argmin is a (m, nc) matmul epilogue instead of the reference's gather of
n_cluster^g_cd enumerated options.  update_C builds the (nc·vec)² normal
matrix with batched one-hot einsums instead of per-row Kronecker
scatters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from qpalette_tpu.ops import packing
from qpalette_tpu.quant.ldlq import regularize_h
from qpalette_tpu.utils.kmeans import kmeans

# full normal-equation solve is O(m·d·(nc·vec)·n) to build; above this the
# closed-form C update falls back to the diagonal-weighted estimate (the
# reference's update_batch_P likewise skips groups with too many options,
# nuq_op.py:117-119)
_FULL_C_MAX = 1024

# full f32 products (the GPU's default f32 matmul is TF32)
_HI = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("nc",))
def _assign(vecs, C, nc):
    norms = jnp.sum(C * C, axis=1)
    cross = jnp.matmul(vecs, C.T, precision=_HI)
    return jnp.argmin(norms[None, :] - 2.0 * cross, axis=1)


@functools.partial(jax.jit, static_argnames=("nc", "vec", "cycles"))
def _cd_update(W, H, assign, C, nc: int, vec: int, cycles: int = 2):
    """Exact coordinate descent on assignments under obj = tr(Δ H Δᵀ).

    For position block j, the best centroid minimizes
      (c-w_j) Q (c-w_j)ᵀ + 2 (c-w_j)·r_j,  Q = H[j-block, j-block],
      r_j = Σ_{k∉j} Δ_k H[k, j-block] = S_j - Δ_j Q
    which reduces to argmin_c [ c Q cᵀ - 2 c·(Q w_j - r_j) ] — one (m, nc)
    matmul per position.  S is maintained by rank-vec updates.
    """
    m, n = W.shape
    d = n // vec
    hat = jnp.take(C, assign, axis=0).reshape(m, n)
    delta = hat - W
    S = jnp.matmul(delta, H, precision=_HI)  # (m, n)

    def step(carry, j):
        delta, S, assign = carry
        jv = j * vec
        Q = jax.lax.dynamic_slice(H, (jv, jv), (vec, vec))
        Hrows = jax.lax.dynamic_slice(H, (jv, 0), (vec, n))
        dj = jax.lax.dynamic_slice(delta, (0, jv), (m, vec))
        sj = jax.lax.dynamic_slice(S, (0, jv), (m, vec))
        wj = jax.lax.dynamic_slice(W, (0, jv), (m, vec))
        r = sj - jnp.matmul(dj, Q, precision=_HI)  # (m, vec); Q symmetric
        qq = jnp.sum(jnp.matmul(C, Q, precision=_HI) * C, axis=1)  # (nc,)
        lin = jnp.matmul(jnp.matmul(wj, Q, precision=_HI) - r, C.T,
                         precision=_HI)  # (m, nc)
        obj = qq[None, :] - 2.0 * lin
        a_new = jnp.argmin(obj, axis=1).astype(assign.dtype)
        cnew = jnp.take(C, a_new, axis=0)  # (m, vec)
        dnew = cnew - wj
        ddiff = dnew - dj
        delta = jax.lax.dynamic_update_slice(delta, dnew, (0, jv))
        S = S + jnp.matmul(ddiff, Hrows, precision=_HI)
        assign = assign.at[:, j].set(a_new)
        return (delta, S, assign), None

    for _ in range(cycles):
        (delta, S, assign), _ = jax.lax.scan(step, (delta, S, assign),
                                             jnp.arange(d))
    return assign


@functools.partial(jax.jit, static_argnames=("nc", "vec"))
def _centroid_solve(W, H, assign, nc: int, vec: int, chunk: int = 16):
    """Closed-form LS centroid update (reference update_C, nuq_op.py:226-265).

    Normal equations A·vec(C) = b over the full Hessian objective:
      A[(c1,u),(c2,v)] = Σ_rows Σ_{j∈c1, k∈c2} H[j·vec+u, k·vec+v]
      b[(c,u)]         = Σ_rows Σ_{j∈c}       (W H)[row, j·vec+u]
    built with batched one-hot einsums (no Kronecker materialization)."""
    m, n = W.shape
    d = n // vec
    k = nc * vec
    WH = jnp.matmul(W, H, precision=_HI)  # (m, n)
    b = (jnp.zeros((nc, vec), H.dtype)
         .at[assign].add(WH.reshape(m, d, vec))).reshape(k)

    Hr = H.reshape(d, vec, n)

    def body(acc, a_chunk):  # a_chunk (B, d)
        P = jax.nn.one_hot(a_chunk, nc, dtype=H.dtype)  # (B, d, nc)
        # R[b, c1, u, :] = Σ_{j∈c1} H[j·vec+u, :]
        R = jnp.einsum("jun,bjc->bcun", Hr, P,
                       precision=_HI)  # (B, nc, vec, n)
        Rr = R.reshape(-1, k, d, vec)
        Ab = jnp.einsum("bkjv,bjc->kcv", Rr, P,
                        precision=_HI)  # (k, nc, vec)
        return acc + Ab.reshape(k, k), None

    B = chunk if m % chunk == 0 else 1
    A, _ = jax.lax.scan(body, jnp.zeros((k, k), H.dtype),
                        assign.reshape(m // B, B, d))
    # ridge for empty clusters / rank deficiency
    A = A + (1e-6 * jnp.trace(A) / k) * jnp.eye(k, dtype=A.dtype)
    Cf = jnp.linalg.solve(A, b)
    return Cf.reshape(nc, vec)


def quantize_mat_vq_als(Wr, HRr, bits: int, vec: int, use_hess: bool = False,
                        iters: int = 4, cd_cycles: int = 2):
    m, n = Wr.shape
    Wf = np.asarray(Wr, np.float32)
    vecs = Wf.reshape(-1, vec)
    nc = 1 << bits
    C = kmeans(vecs[np.random.default_rng(0).choice(
        len(vecs), min(len(vecs), 1 << 18), replace=False)], nc, iters=25)
    C = jnp.asarray(C, jnp.float32)
    vj = jnp.asarray(vecs)
    Wj = jnp.asarray(Wf)

    if use_hess and HRr is not None:
        H = regularize_h(jnp.asarray(HRr, jnp.float32))
        assign = _assign(vj, C, nc).reshape(m, n // vec).astype(jnp.int32)
        full_C = nc * vec <= _FULL_C_MAX
        for _ in range(iters):
            assign = _cd_update(Wj, H, assign, C, nc, vec, cd_cycles)
            if full_C:
                C = _centroid_solve(Wj, H, assign, nc, vec)
            else:
                # diagonal-weighted fallback (too many centroids for the
                # full normal solve; mirrors the reference's skip guard)
                dw = jnp.clip(jnp.diagonal(H), 1e-8)
                w = jnp.tile(dw.reshape(1, n // vec, vec),
                             (m, 1, 1)).reshape(-1, vec)
                aflat = assign.reshape(-1)
                num = jnp.zeros((nc, vec)).at[aflat].add(vj * w)
                den = jnp.zeros((nc, vec)).at[aflat].add(w)
                C = jnp.where(den > 0, num / jnp.maximum(den, 1e-8), C)
        assign = _cd_update(Wj, H, assign, C, nc, vec, cd_cycles)
        idx = assign.reshape(-1)
    else:
        for _ in range(iters):
            idx = _assign(vj, C, nc)
            num = jnp.zeros((nc, vec)).at[idx].add(vj)
            den = jnp.zeros((nc, vec)).at[idx].add(jnp.ones_like(vj))
            C = jnp.where(den > 0, num / jnp.maximum(den, 1e-8), C)
        idx = _assign(vj, C, nc)

    hat = jnp.take(C, idx, axis=0).reshape(m, n)
    packed = packing.pack_rows(idx.reshape(m, n // vec).astype(jnp.int32),
                               bits)
    linear = {
        "kind": "vq", "bits": bits, "vec": vec,
        "qweight": np.asarray(packed),
        "lut": np.asarray(C, np.float32),
        "in_features": n, "out_features": m,
    }
    return linear, hat
