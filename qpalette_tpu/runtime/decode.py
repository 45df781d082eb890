"""Decode engine: jitted single-token step + generation loop + sampling.

Reference behavior: eval/measure_latency.py — `decode_one_tokens` under
torch.compile(max-autotune, fullgraph) with a preallocated StaticCache
(:122-161, :201-226), multinomial top-k sampling without sync (:102-126),
and tokens/s + achieved-GB/s + TF/s reporting (:266-273).

The whole step (forward + sample) is one jit; the KV cache is a
statically-shaped pytree threaded through lax-style; generation runs the
python loop around a fully-device-resident step (one dispatch per token).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from qpalette_tpu.models import llama


def sample_logits(logits: jax.Array, key: jax.Array, temperature: float,
                  top_k: Optional[int]) -> jax.Array:
    """logits (B, vocab) -> token ids (B,).  Gumbel top-k trick (the
    reference's exponential-race sampler, measure_latency.py:102-107)."""
    if temperature == 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    logits = logits / max(temperature, 1e-5)
    if top_k is not None:
        # Sample among the top-k values directly: identical in law to
        # gumbel-argmax over the top-k-masked vocab, but the gumbel draw
        # is (B, k) instead of (B, vocab).
        v, idx = jax.lax.top_k(logits, top_k)
        g = jax.random.gumbel(key, v.shape)
        choice = jnp.argmax(v + g, axis=-1)
        return jnp.take_along_axis(idx, choice[:, None], axis=1)[:, 0] \
            .astype(jnp.int32)
    g = jax.random.gumbel(key, logits.shape)
    return jnp.argmax(logits + g, axis=-1).astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("spec", "temperature", "top_k"))
def decode_step(spec, params, tokens, kv_caches, cache_pos, key,
                temperature: float = 0.6, top_k: Optional[int] = 5):
    """One decode step: tokens (B, 1) at cache_pos -> (next (B, 1), caches)."""
    logits, kv_caches = llama.forward(spec, params, tokens,
                                      kv_caches=kv_caches,
                                      cache_pos=cache_pos)
    nxt = sample_logits(logits[:, -1], key, temperature, top_k)
    return nxt[:, None], kv_caches


@functools.partial(jax.jit, static_argnames=("spec",))
def prefill(spec, params, tokens, kv_caches):
    logits, kv_caches = llama.forward(spec, params, tokens,
                                      kv_caches=kv_caches, cache_pos=0)
    return logits, kv_caches


def generate(spec, params, prompt: np.ndarray, max_new_tokens: int,
             max_seq: Optional[int] = None, temperature: float = 0.6,
             top_k: Optional[int] = 5, seed: int = 1234):
    """Greedy/sampled generation.  prompt (B, S) int32.

    Returns (tokens (B, S+max_new), stats dict with tokens/s measured over
    the decode loop only, cf. measure_latency.py:236-273)."""
    B, S = prompt.shape
    T = max_seq or (S + max_new_tokens)
    caches = llama.init_kv_caches(spec, B, T)
    tokens = jnp.asarray(prompt, jnp.int32)
    logits, caches = prefill(spec, params, tokens, caches)
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    cur = sample_logits(logits[:, -1], k0, temperature, top_k)[:, None]

    outs = [cur]
    # warmup/compile one step, then time the loop
    pos = S
    cur, caches = decode_step(spec, params, cur, caches,
                              jnp.int32(pos), key, temperature, top_k)
    outs.append(cur)
    pos += 1
    jax.block_until_ready(cur)

    t0 = time.perf_counter()
    n_timed = 0
    for i in range(max_new_tokens - 2):
        key, sk = jax.random.split(key)
        cur, caches = decode_step(spec, params, cur, caches,
                                  jnp.int32(pos), sk, temperature, top_k)
        outs.append(cur)
        pos += 1
        n_timed += 1
    np.asarray(cur)
    dt = time.perf_counter() - t0
    toks_per_s = (n_timed * B / dt) if n_timed else float("nan")

    seq = np.concatenate([np.asarray(prompt)] +
                         [np.asarray(o) for o in outs], axis=1)
    return seq, {"tokens_per_sec": toks_per_s, "decode_time_s": dt,
                 "timed_tokens": n_timed}


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_tokens", "temperature",
                                    "top_k"))
def generate_scan(spec, params, first_token, kv_caches, start_pos, key,
                  n_tokens: int, temperature: float = 0.6,
                  top_k: Optional[int] = 5):
    """Whole decode loop as one lax.scan inside a single jit dispatch.

    first_token (B, 1); returns (tokens (B, n_tokens), final caches).
    This stands in for the reference's CUDA-graph capture
    (lib/utils/graph_wrapper.py / torch.compile decode loop): one device
    program per generation burst instead of one per token.
    """
    def step(carry, i):
        tok, caches, k = carry
        k, sk = jax.random.split(k)
        logits, caches = llama.forward(spec, params, tok,
                                       kv_caches=caches,
                                       cache_pos=start_pos + i)
        nxt = sample_logits(logits[:, -1], sk, temperature, top_k)[:, None]
        return (nxt, caches, k), nxt[:, 0]

    (_, caches, _), toks = jax.lax.scan(
        step, (first_token, kv_caches, key), jnp.arange(n_tokens))
    return toks.T, caches


def generate_fast(spec, params, prompt: np.ndarray, max_new_tokens: int,
                  max_seq: Optional[int] = None, temperature: float = 0.6,
                  top_k: Optional[int] = 5, seed: int = 1234):
    """Generation with the scan-based loop; returns (seq, stats)."""
    B, S = prompt.shape
    T = max_seq or (S + max_new_tokens)
    caches = llama.init_kv_caches(spec, B, T)
    tokens = jnp.asarray(prompt, jnp.int32)
    logits, caches = prefill(spec, params, tokens, caches)
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    cur = sample_logits(logits[:, -1], k0, temperature, top_k)[:, None]

    n = max_new_tokens - 1
    # compile + warm on the same (immutable) inputs, then time a second
    # identical call
    toks, _ = generate_scan(spec, params, cur, caches, jnp.int32(S), key,
                            n, temperature, top_k)
    np.asarray(toks)
    t0 = time.perf_counter()
    toks, caches = generate_scan(spec, params, cur, caches, jnp.int32(S),
                                 key, n, temperature, top_k)
    toks_np = np.asarray(toks)
    dt = time.perf_counter() - t0
    seq = np.concatenate([np.asarray(prompt), np.asarray(cur), toks_np],
                         axis=1)
    return seq, {"tokens_per_sec": n * B / dt, "decode_time_s": dt,
                 "timed_tokens": n}


def model_bytes(params) -> int:
    """Total on-device parameter+buffer bytes (for achieved-GB/s reporting,
    reference measure_latency.py:164-186)."""
    leaves = jax.tree.leaves(params)
    return int(sum(x.size * x.dtype.itemsize for x in leaves))
