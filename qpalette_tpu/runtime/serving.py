"""Continuous-batching decode engine.

The reference has no serving layer (single-prompt throughput script only);
this implements the north-star serving surface: a fixed pool of batch
slots, each with its own KV-cache position, admitting new requests as
slots free up.  The decode step is one jit over the whole slot pool with
per-slot positions (models/llama.py handles vector cache_pos), so
admission/completion never triggers recompilation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from qpalette_tpu.models import llama
from qpalette_tpu.runtime.decode import sample_logits


@functools.partial(jax.jit, static_argnames=("spec", "temperature", "top_k"))
def _pool_step(spec, params, tokens, caches, positions, active, key,
               temperature: float = 0.6, top_k: Optional[int] = 5):
    """tokens (B, 1); positions (B,); active (B,) bool."""
    logits, caches = llama.forward(spec, params, tokens, kv_caches=caches,
                                   cache_pos=positions)
    nxt = sample_logits(logits[:, -1], key, temperature, top_k)
    nxt = jnp.where(active, nxt, 0)
    return nxt[:, None], caches


@functools.partial(jax.jit, static_argnames=("spec", "n", "temperature",
                                             "top_k"))
def _pool_burst(spec, params, tokens, caches, positions, active, key,
                n: int, temperature: float = 0.6,
                top_k: Optional[int] = 5):
    """n decode steps across the pool in ONE dispatch (lax.scan).

    Multi-step scheduling: admission/completion checks happen between
    bursts, so per-token host/dispatch overhead is amortized n-fold.  The scheduler only bursts min(remaining)
    tokens, so no request overshoots its budget."""
    def it(carry, _):
        tok, cs, pos, k = carry
        k, sk = jax.random.split(k)
        logits, cs = llama.forward(spec, params, tok, kv_caches=cs,
                                   cache_pos=pos)
        nxt = sample_logits(logits[:, -1], sk, temperature, top_k)
        nxt = jnp.where(active, nxt, 0)
        return (nxt[:, None], cs, pos + 1, k), nxt

    (tok, caches, pos, _), toks = jax.lax.scan(
        it, (tokens, caches, positions, key), None, length=n)
    return toks.T, caches


@functools.partial(jax.jit, static_argnames=("spec",))
def _prefill_slots(spec, params, caches, slots, tokens, pos0):
    """Batched admission: several slots' prompt chunks in ONE dispatch.

    slots (B',) int32; tokens (B', C); pos0 (B',) per-slot start
    positions (models/llama.forward handles vector cache_pos).  The
    slots' cache rows are gathered, run through one batched forward, and
    scattered back — admission cost for a burst of arrivals drops from
    one model dispatch per request to one per (distinct chunk shape)."""
    sliced = [tuple(jnp.take(c, slots, axis=0) for c in kv)
              for kv in caches]
    # return_hidden: admission only needs the KV writes — skip the
    # lm_head entirely (the int8 head's prefill path would otherwise
    # materialize the dequantized f32 table and full per-position logits)
    _, new_sliced = llama.forward(spec, params, tokens, kv_caches=sliced,
                                  cache_pos=pos0, return_hidden=True)
    return [tuple(c.at[slots].set(cn) for c, cn in zip(kv, kvn))
            for kv, kvn in zip(caches, new_sliced)]


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-pool scheduler: submit() requests, step() the pool, collect()."""

    def __init__(self, spec, params, n_slots: int = 4, max_seq: int = 512,
                 temperature: float = 0.6, top_k: Optional[int] = 5,
                 eos_id: Optional[int] = None, seed: int = 0,
                 prefill_chunk: int = 256):
        self.spec, self.params = spec, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.prefill_chunk = prefill_chunk
        self.temperature, self.top_k = temperature, top_k
        self.eos_id = eos_id
        self.caches = llama.init_kv_caches(spec, n_slots, max_seq)
        self.positions = np.zeros((n_slots,), np.int32)
        self.cur = np.zeros((n_slots, 1), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.key = jax.random.PRNGKey(seed)
        self._next_rid = 0

    def submit(self, prompt: List[int], max_new_tokens: int = 64) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens))
        return rid

    def _admit(self):
        # assign waiting requests to free slots, then prefill their
        # prompt contexts in chunk ROUNDS: within each round, all chunks
        # of equal length batch into ONE _prefill_slots dispatch
        # (admission for a burst of arrivals costs one model dispatch per
        # distinct chunk shape, not one per request)
        admitted = []
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                self.positions[slot] = 0
                admitted.append(slot)
        if not admitted:
            return
        C = self.prefill_chunk
        chunks = {}  # slot -> list of (tokens, pos)
        for slot in admitted:
            req = self.slot_req[slot]
            ctx = req.prompt[:-1]
            lst = []
            pos = 0
            for c0 in range(0, (len(ctx) // C) * C, C):
                lst.append((ctx[c0:c0 + C], pos))
                pos += C
            tail = ctx[(len(ctx) // C) * C:]
            if tail:
                lst.append((tail, pos))
                pos += len(tail)
            chunks[slot] = lst
            self.positions[slot] = pos
            self.cur[slot, 0] = req.prompt[-1]
        rounds = max(len(v) for v in chunks.values())
        for r in range(rounds):
            by_len: Dict[int, List[int]] = {}
            for slot, lst in chunks.items():
                if r < len(lst):
                    by_len.setdefault(len(lst[r][0]), []).append(slot)
            for L, slots in by_len.items():
                toks = np.array([chunks[s][r][0] for s in slots], np.int32)
                pos0 = np.array([chunks[s][r][1] for s in slots], np.int32)
                self.caches = _prefill_slots(
                    self.spec, self.params, self.caches,
                    jnp.asarray(np.array(slots, np.int32)),
                    jnp.asarray(toks), jnp.asarray(pos0))

    def step(self):
        """One decode step across all active slots."""
        self._admit()
        active = np.array([r is not None for r in self.slot_req])
        if not active.any():
            return False
        self.key, sk = jax.random.split(self.key)
        nxt, self.caches = _pool_step(
            self.spec, self.params, jnp.array(self.cur), self.caches,
            jnp.array(self.positions), jnp.array(active), sk,
            self.temperature, self.top_k)
        nxt = np.asarray(nxt)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.positions[slot] += 1
            tok = int(nxt[slot, 0])
            req.output.append(tok)
            self.cur[slot, 0] = tok
            full = self.positions[slot] + 1 >= self.max_seq
            if (len(req.output) >= req.max_new_tokens or full
                    or (self.eos_id is not None and tok == self.eos_id)):
                req.done = True
                self.finished[req.rid] = req
                self.slot_req[slot] = None
                self.positions[slot] = 0
        return True

    def step_burst(self, n: int):
        """n decode steps in one dispatch (no admission in between)."""
        active = np.array([r is not None for r in self.slot_req])
        self.key, sk = jax.random.split(self.key)
        toks, self.caches = _pool_burst(
            self.spec, self.params, jnp.array(self.cur), self.caches,
            jnp.array(self.positions), jnp.array(active), sk, n,
            self.temperature, self.top_k)
        toks = np.asarray(toks)  # (B, n)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.positions[slot] += n
            req.output.extend(int(t) for t in toks[slot])
            self.cur[slot, 0] = int(toks[slot, -1])
            full = self.positions[slot] + 1 >= self.max_seq
            eos_hit = (self.eos_id is not None
                       and self.eos_id in toks[slot].tolist())
            if eos_hit:
                cut = toks[slot].tolist().index(self.eos_id) + 1
                req.output = req.output[: len(req.output) - n + cut]
            if len(req.output) >= req.max_new_tokens or full or eos_hit:
                req.done = True
                self.finished[req.rid] = req
                self.slot_req[slot] = None
                self.positions[slot] = 0

    def run(self, max_steps: int = 10000, burst: int = 16):
        """Drive to completion.  burst > 1 uses multi-step scheduling:
        between admissions, up to `burst` tokens decode in one dispatch
        (bounded by the minimum remaining budget so nothing overshoots;
        EOS inside a burst trims the output post-hoc)."""
        steps = 0
        while (any(r is not None for r in self.slot_req) or self.queue) \
                and steps < max_steps:
            self._admit()
            rem = [r.max_new_tokens - len(r.output)
                   for r in self.slot_req if r is not None]
            room = [self.max_seq - 1 - self.positions[s]
                    for s, r in enumerate(self.slot_req) if r is not None]
            n = min([burst] + rem + room) if rem else 0
            if n >= 2:
                self.step_burst(n)
            else:
                self.step()
            steps += 1
        return self.finished
