"""Randomized-Hadamard incoherence rotations.

Reference behavior: /root/reference/lib/utils/matmul_had.py — ``get_hadK(n)``
factors n = K * 2^p with a hardcoded table of Hadamard matrices
(K ∈ {12, 20, 28, ...}) and applies a CUDA fast-Walsh butterfly for the 2^p
part (``matmul_hadU_cuda`` :137) plus a K×K matmul for the odd factor.

Design: no butterfly kernel.  A Walsh-Hadamard transform of size
n = K * a * b is the Kronecker product H_K ⊗ H_a ⊗ H_b, which we apply as
small dense matmuls (reshape to (..., K, a, b) and contract each axis).  For
n up to 2^15 every factor is ≤ 256, and XLA fuses the surrounding
elementwise work (sign flips, scales).

Non-power-of-2 factors: instead of shipping Sloane's matrix tables
(reference matmul_had.py:161-95747) we *construct* Hadamard matrices with the
Paley I/II constructions where they exist, and otherwise fall back to a
deterministic seeded random orthogonal matrix (same incoherence guarantees;
artifacts are self-consistent within this framework).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "get_had_factors",
    "hadamard_matrix",
    "hadamard_transform",
    "hadamard_transform_t",
    "random_signs",
]


def _is_prime(q: int) -> bool:
    if q < 2:
        return False
    for f in range(2, int(q**0.5) + 1):
        if q % f == 0:
            return False
    return True


def _paley_core(q: int) -> np.ndarray:
    """Jacobsthal matrix Q[i, j] = chi(i - j) over GF(q), q prime."""
    residues = set((i * i) % q for i in range(1, q))
    chi = np.zeros(q, dtype=np.int64)
    for r in range(1, q):
        chi[r] = 1 if r in residues else -1
    i = np.arange(q)
    return chi[(i[:, None] - i[None, :]) % q]


def _paley1(q: int) -> np.ndarray:
    """Paley I Hadamard matrix of order q + 1 (q prime, q ≡ 3 mod 4)."""
    Q = _paley_core(q)
    n = q + 1
    H = np.ones((n, n), dtype=np.int64)
    H[1:, 0] = -1
    H[1:, 1:] = Q + np.eye(q, dtype=np.int64)
    return H


def _paley2(q: int) -> np.ndarray:
    """Paley II Hadamard matrix of order 2(q + 1) (q prime, q ≡ 1 mod 4)."""
    Q = _paley_core(q)
    m = q + 1
    C = np.zeros((m, m), dtype=np.int64)
    C[0, 1:] = 1
    C[1:, 0] = 1
    C[1:, 1:] = Q
    P = np.array([[1, 1], [1, -1]], dtype=np.int64)
    N = np.array([[1, -1], [-1, -1]], dtype=np.int64)
    return np.kron(C, P) + np.kron(np.eye(m, dtype=np.int64), N)


@functools.lru_cache(maxsize=None)
def hadamard_matrix(k: int) -> np.ndarray:
    """Orthogonal k×k matrix with H @ H.T = k * I.

    Hadamard (entries ±1) when constructible by Sylvester/Paley; otherwise a
    seeded random orthogonal matrix scaled by sqrt(k) (still satisfies
    H @ H.T = k I, entries are O(1) — the only property incoherence
    processing needs).
    """
    if k == 1:
        return np.ones((1, 1))
    if k & (k - 1) == 0:  # power of two: Sylvester
        H = np.array([[1.0]])
        while H.shape[0] < k:
            H = np.block([[H, H], [H, -H]])
        return H
    if k % 4 == 0:
        q = k - 1
        if _is_prime(q) and q % 4 == 3:
            return _paley1(q).astype(np.float64)
        q = k // 2 - 1
        if k % 8 == 4 and _is_prime(q) and q % 4 == 1:
            return _paley2(q).astype(np.float64)
    if k % 2 == 0:
        # Composite even order: H_k = H_{k/2} ⊗ H_2.  Entries stay ±1
        # whenever the odd core is Paley/Sylvester-constructible (e.g.
        # 56 = 28·2, 112 = 28·4) — lets get_had_factors use wide
        # factors without losing incoherence flatness.
        H2 = np.array([[1.0, 1.0], [1.0, -1.0]])
        return np.kron(hadamard_matrix(k // 2), H2)
    # Fallback: seeded random orthogonal, scaled to match H H^T = k I.
    rng = np.random.default_rng(k * 7919 + 13)
    A = rng.standard_normal((k, k))
    Qm, R = np.linalg.qr(A)
    Qm = Qm * np.sign(np.diag(R))[None, :]
    return Qm * np.sqrt(k)

    # check done in tests: np.allclose(H @ H.T, k * np.eye(k))


def _odd_part(n: int) -> int:
    while n % 2 == 0:
        n //= 2
    return n


@functools.lru_cache(maxsize=None)
def get_had_factors(n: int) -> tuple[int, ...]:
    """Factor n into Kronecker factors (K, a, b, ...), each ≤ 256.

    Mirrors the role of reference get_hadK (matmul_had.py:10-65): pick the
    non-power-of-2 factor K, then split the remaining power of two into
    chunks of at most 256.  Rule: m = odd(n); K = 1 if m == 1, else 4*m if a
    Paley/Sylvester Hadamard of order 4m exists (e.g. 7→28, 3→12, 5→20,
    27→108), else m itself with a random-orthogonal factor (e.g. 43 for
    Llama-2-7B's 11008).
    """
    assert n > 0
    m = _odd_part(n)
    if m == 1:
        K = 1
    else:
        K = 4 * m
        Hk = hadamard_matrix(K)
        if not np.allclose(Hk @ Hk.T, K * np.eye(K)):
            raise AssertionError(f"bad Hadamard order {K}")
        if np.abs(Hk).max() > 1.5:  # random-orthogonal fallback was used
            K = m
        if n % K != 0:
            K = m
    p2 = n // K
    assert p2 & (p2 - 1) == 0, f"n={n} must be K * 2^p"
    if n <= 256:
        return (n,)
    # Exactly two factors (a, b), both ≤ 256: _apply then runs ONE
    # relayout-free dual matmul (Haᵀ X H_b) instead of a moveaxis+dot per
    # factor (fewer small ops per decode rotation).
    for b in (256, 128, 64, 32, 16, 8, 4, 2):
        if p2 % b == 0 and n // b <= 256:
            return (n // b, b)
    # n > 65536: fall back to >2 Kronecker factors
    factors = [] if K == 1 else [K]
    while p2 > 256:
        factors.append(256)
        p2 //= 256
    if p2 > 1:
        factors.append(p2)
    factors = [factors[0]] + sorted(factors[1:])
    return tuple(factors)


@functools.lru_cache(maxsize=None)
def _factor_mats(n: int, transpose: bool, dtype_name: str):
    # cache plain numpy (jnp arrays created under a jit trace would leak
    # tracers through this cache); tracing lifts them to constants per use
    facs = get_had_factors(n)
    mats = []
    for k in facs:
        H = hadamard_matrix(k)
        if transpose:
            H = H.T
        mats.append(np.ascontiguousarray(H, dtype=np.dtype(dtype_name)))
    return facs, mats


def _apply(x: jax.Array, n: int, transpose: bool) -> jax.Array:
    """x[..., n] -> x @ (H_n / sqrt(n)) with H_n = kron(factors)."""
    orig_shape = x.shape
    orig_dtype = x.dtype
    cdt = jnp.float32 if x.dtype != jnp.float64 else jnp.float64
    # f32 inputs (weights and Hessians at quantization time) need a full
    # f32 product: the GPU's default f32 matmul is TF32.  bf16 inputs are
    # exact in TF32 (the factors are ±1).
    prec = (jax.lax.Precision.HIGHEST
            if x.dtype in (jnp.float32, jnp.float64) else None)
    facs, mats = _factor_mats(n, transpose, str(np.dtype(cdt)))
    if len(facs) == 2:
        # one dual-sided contraction (Hₐ'X H_b'): two matmuls, no
        # relayouts — the decode-path fast case (all Llama dims)
        a, b = facs
        x2 = x.reshape((-1, a, b)).astype(cdt)
        y = jnp.einsum("zij,ia,jb->zab", x2, jnp.asarray(mats[0]),
                       jnp.asarray(mats[1]), precision=prec)
        y = y * np.float64(n) ** -0.5
        return y.reshape(orig_shape).astype(orig_dtype)
    x = x.reshape((-1,) + facs).astype(cdt)
    # contract each factor axis with its (small) Hadamard matrix
    for ax, H in enumerate(mats):
        axis = 1 + ax
        x = jnp.moveaxis(x, axis, -1)
        x = jax.lax.dot_general(
            x, jnp.asarray(H), (((x.ndim - 1,), (0,)), ((), ())),
            precision=prec, preferred_element_type=cdt)
        x = jnp.moveaxis(x, -1, axis)
    x = x * np.float64(n) ** -0.5
    return x.reshape(orig_shape).astype(orig_dtype)


def _apply_blocks(x: jax.Array, blocks: int, transpose: bool) -> jax.Array:
    """Block-diagonal transform: I_blocks ⊗ Ĥ_{n/blocks} along the last axis.

    This is the tensor-parallel rotation of the reference's `rcp` hooks
    (lib/codebook/bitshift.py:374-388, lib/utils/data_utils.py:287-308):
    when a projection's *input* dim is sharded over tp devices, the
    incoherence Hadamard must act per shard of size n/tp so each device can
    rotate its local activations without communication."""
    n = x.shape[-1]
    assert n % blocks == 0, (n, blocks)
    shp = x.shape
    x = x.reshape(shp[:-1] + (blocks, n // blocks))
    out = _apply(x, n // blocks, transpose=transpose)
    return out.reshape(shp)


def hadamard_transform(x: jax.Array, axis: int = -1,
                       blocks: int = 1) -> jax.Array:
    """Orthonormal Hadamard transform along ``axis`` (y = x @ Ĥ, Ĥ Ĥᵀ = I).

    Runtime (decode-path) rotation; the quantize path uses
    :func:`hadamard_transform_t` so that Ĥᵀ Ĥ = I composes to identity.
    Replaces reference matmul_hadU_cuda / fast_hadamard_transform.
    ``blocks > 1`` applies a block-diagonal I_b ⊗ Ĥ (tensor-parallel `rcp`
    rotation; see _apply_blocks).
    """
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        x = jnp.moveaxis(x, axis, -1)
        out = hadamard_transform(x, -1, blocks)
        return jnp.moveaxis(out, -1, axis)
    if blocks != 1:
        return _apply_blocks(x, blocks, transpose=False)
    return _apply(x, x.shape[-1], transpose=False)


def hadamard_transform_t(x: jax.Array, axis: int = -1,
                         blocks: int = 1) -> jax.Array:
    """Transpose transform (y = x @ Ĥᵀ) — quantization-side rotation.

    Mirrors reference matmul_hadUt (matmul_had.py:90).
    """
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        x = jnp.moveaxis(x, axis, -1)
        out = hadamard_transform_t(x, -1, blocks)
        return jnp.moveaxis(out, -1, axis)
    if blocks != 1:
        return _apply_blocks(x, blocks, transpose=True)
    return _apply(x, x.shape[-1], transpose=True)


def random_signs(n: int, key: jax.Array) -> jax.Array:
    """±1 sign vector (the SU/SV of incoherence processing).

    Mirrors reference get_random_sign (quantize_layer.py:102-103).
    """
    return (jax.random.bernoulli(key, 0.5, (n,)).astype(jnp.float32) * 2.0 - 1.0)
