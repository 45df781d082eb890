"""Tail-biting Viterbi encoder for the bitshift trellis (TCQ).

Reference behavior: lib/codebook/bitshift.py:202-294 — a torch.compile'd DP
over 2^16 states with gathers over 2^KV candidate predecessors, batched over
columns, plus the two-pass tail-biting scheme (roll by half, re-encode with
the junction state constrained).

Redesign (same math, different convention and kernelization):

* Transition convention: s_{i+1} = (s_i >> KV) | (new_bits << (L-KV)), chosen
  so that (see ops/packing.py) a state is a plain little-endian bit window
  and — crucially — the predecessors of state s form the *contiguous* range
  [(s & mask) << KV, ((s & mask) + 1) << KV).  The DP min-over-predecessors
  is then a reshape + minor-axis reduction, not a gather.
* Distance computation is a matmul: ||lut[s] - x||² = ||lut[s]||² - 2·x·lut[s]
  (+ const) so each DP step is one (B, V) @ (V, 2^L) matmul (full f32)
  plus elementwise.
* The whole encode is a single lax.scan; backtrace pointers are 2^KV-way
  argmins stored as uint8.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

L = 16
V = 2
NSTATES = 1 << L


def _dp_tables(lut: jax.Array):
    lutf = lut.astype(jnp.float32)  # (2^L, V)
    norms = jnp.sum(lutf * lutf, axis=1)  # (2^L,)
    return lutf, norms


def _state_err(x_step: jax.Array, lutf: jax.Array, norms: jax.Array):
    """x_step (B, V) -> err (B, 2^L) up to a per-step constant."""
    cross = jax.lax.dot_general(
        x_step.astype(jnp.float32), lutf.T,
        (((1,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return norms[None, :] - 2.0 * cross


@functools.partial(jax.jit, static_argnames=("KV", "v"))
def viterbi_encode(X: jax.Array, lut: jax.Array, KV: int,
                   init_c: Optional[jax.Array] = None,
                   final_c: Optional[jax.Array] = None,
                   v: int = V) -> jax.Array:
    """Encode sequences X (B, S*v) into trellis states (B, S).

    init_c / final_c (each (B,) int32 in [0, 2^(L-KV)) or None) constrain
    s_0 & mask == init_c and s_{S-1} >> KV == final_c (the tail-biting
    junction constraints; cf. reference bitshift.py:228-249 overlap masks).
    v = weights per state (lut is (2^L, v)).
    """
    B, TV = X.shape
    S = TV // v
    NQ = 1 << (L - KV)  # carry-part cardinality
    NR = 1 << KV        # new-bits cardinality
    lutf, norms = _dp_tables(lut)
    Xs = X.reshape(B, S, v).transpose(1, 0, 2)  # (S, B, v)

    big = jnp.float32(1e30)
    cost0 = _state_err(Xs[0], lutf, norms)  # (B, 2^L)
    if init_c is not None:
        # allow only states whose low L-KV bits equal init_c
        q = jax.lax.broadcasted_iota(jnp.int32, (NR, NQ), 1).reshape(-1)
        allowed = q[None, :] == init_c[:, None]
        cost0 = jnp.where(allowed, cost0, big)

    bp_dtype = jnp.uint8 if KV <= 8 else jnp.int32  # NR = 2^KV indices

    def step(cost, x_step):
        err = _state_err(x_step, lutf, norms)
        c = cost.reshape(B, NQ, NR)
        bp = jnp.argmin(c, axis=2).astype(bp_dtype)  # (B, NQ)
        mn = jnp.min(c, axis=2)  # (B, NQ)
        # cost_new[s'] = err[s'] + mn[s' & mask];  s' = t * NQ + q
        new_cost = err.reshape(B, NR, NQ) + mn[:, None, :]
        return new_cost.reshape(B, NSTATES), bp

    cost, bps = jax.lax.scan(step, cost0, Xs[1:])  # bps (S-1, B, NQ)

    if final_c is not None:
        cr = cost.reshape(B, NQ, NR)
        sel = (jax.lax.broadcasted_iota(jnp.int32, (B, NQ), 1)
               == final_c[:, None])
        cr = jnp.where(sel[:, :, None], cr, big)
        cost = cr.reshape(B, NSTATES)

    last = jnp.argmin(cost, axis=1).astype(jnp.int32)  # (B,)

    def back(s, bp):
        q = s & (NQ - 1)
        r = jnp.take_along_axis(bp, q[:, None], axis=1)[:, 0].astype(jnp.int32)
        prev = (q << KV) | r
        return prev, s

    # bps[j] holds pointers for the transition into time j+1; the reverse
    # scan yields ys[j] = s_{j+1} and its final carry is s_0.
    s0, states = jax.lax.scan(back, last, bps, reverse=True)  # (S-1, B)
    states = jnp.concatenate([s0[None, :], states], axis=0)
    return states.T  # (B, S)


@functools.partial(jax.jit, static_argnames=("KV", "v"))
def tcq_quantize(X: jax.Array, lut: jax.Array, KV: int, v: int = V):
    """Tail-biting quantization of X (B, 256) -> (hatX, states (B, 256//v)).

    Two passes as in reference bitshift.py:285-294: pass A on the
    half-rotated sequence estimates the wrap state; pass B re-encodes with
    the junction constrained at both ends.
    """
    B, TV = X.shape
    S = TV // v
    NQ = 1 << (L - KV)
    Xroll = jnp.roll(X, (S // 2) * v, axis=1)
    stA = viterbi_encode(Xroll, lut, KV, v=v)  # (B, S)
    # rolled position S//2 is original position 0
    c = (stA[:, S // 2] & (NQ - 1)).astype(jnp.int32)
    states = viterbi_encode(X, lut, KV, init_c=c, final_c=c, v=v)
    hat = jnp.take(lut.astype(jnp.float32), states, axis=0)  # (B, S, v)
    return hat.reshape(B, TV), states
