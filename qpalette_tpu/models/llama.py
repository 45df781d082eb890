"""Llama model family with incoherent quantized linears.

Reference behavior: model/incoherent_llama.py + lib/linear/incoherent_linear.py
(IncoherentSdpaAttention :28-274, IncoherentMLP :279-394) — HF-module forks
where every projection is an incoherence-wrapped quantized linear, with
optional QKV/gate-up merging chosen by the MSQ solver.

Design: pure-functional forward over a params pytree; all
configuration (scheme kinds, shapes, merge layout) lives in hashable static
specs so a single jit trace covers the whole model; decode uses a
statically-shaped KV cache (the reference's StaticCache + torch.compile,
model/cache_utils.py:1048, eval/measure_latency.py:122-161, becomes plain
jit here).  Rotations (SU sign flips + Hadamard) are shared per block
exactly as in the reference (one for q/k/v, one for o, one for up/gate, one
for down — quantize_layer.py:116-123).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import jax
import jax.numpy as jnp

from qpalette_tpu.ops.hadamard import hadamard_transform_t
from qpalette_tpu.runtime.qlinear import LinearSpec, qlinear_apply

Params = Any  # nested dict pytree of jax arrays


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = jnp.bfloat16

    @property
    def kv_out(self) -> int:
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def llama31_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama32_1b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=2048,
                           intermediate_size=8192, num_layers=16,
                           num_heads=32, num_kv_heads=8, head_dim=64,
                           rope_theta=500000.0, tie_embeddings=True)

    @staticmethod
    def llama32_3b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=3072,
                           intermediate_size=8192, num_layers=28,
                           num_heads=24, num_kv_heads=8, head_dim=128,
                           rope_theta=500000.0, tie_embeddings=True)

    @staticmethod
    def tiny(vocab: int = 256) -> "LlamaConfig":
        """Small config for tests: every dim still tile-compatible."""
        return LlamaConfig(vocab_size=vocab, hidden_size=128,
                           intermediate_size=256, num_layers=2,
                           num_heads=4, num_kv_heads=2, head_dim=32,
                           rope_theta=10000.0)


@dataclass(frozen=True)
class AttnSpec:
    """Static layout of one attention block.

    merge ∈ {None, 'qk', 'kv', 'qv', 'qkv'} mirrors the reference merge
    flags (incoherent_linear.py:69-74); merged projections share one fused
    linear whose output is split after the matmul.

    rot_blocks_o > 1: the o_proj input rotation is block-diagonal
    (I_b ⊗ Ĥ) — artifacts quantized for row-parallel tensor sharding
    (reference `rcp` semantics, bitshift.py:374-388).
    """
    merge: Optional[str]
    projs: tuple  # tuple[(name, LinearSpec)], e.g. (("qkv", spec), ("o", o))
    rot_blocks_o: int = 1
    # >0: the o_proj input is BLOCK-PERMUTED before rotation (tp-aware
    # tcomb quantization: blocks [0,2,..,1,3,..] of width n/in_perm_o so
    # every tensor-parallel shard's contiguous slice holds equal KV1/KV2
    # pieces; see parallel/tp.py).  0 = identity.
    in_perm_o: int = 0


@dataclass(frozen=True)
class MLPSpec:
    merge_ug: bool
    projs: tuple  # (("ug"|"up","gate"), ("down", spec))
    rot_blocks_down: int = 1
    in_perm_down: int = 0  # see AttnSpec.in_perm_o


@dataclass(frozen=True)
class ModelSpec:
    config: LlamaConfig
    layers: tuple  # tuple[(AttnSpec, MLPSpec)]
    # set on the per-device local spec inside a shard_map tensor-parallel
    # forward: name of the mesh axis to psum row-parallel (o/down) outputs
    tp_axis: Optional[str] = None
    # non-None: the lm_head is a quantized linear (e.g. 4-bit tcq2s) —
    # params carry "lm_head_q4" + "lm_head_su"; forward rotates the final
    # hidden state and routes it through qlinear_apply
    lm_head_spec: Optional[object] = None


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: jax.Array, w: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype) * w


def rope_tables(positions: jax.Array, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim)."""
    inv = 1.0 / (theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32)
                           / head_dim))
    ang = positions[..., None].astype(jnp.float32) * inv  # (..., hd/2)
    cos = jnp.cos(ang)
    sin = jnp.sin(ang)
    return (jnp.concatenate([cos, cos], axis=-1),
            jnp.concatenate([sin, sin], axis=-1))


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x (..., heads, head_dim); HF-style rotate_half convention."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    rot = jnp.concatenate([-x2, x1], axis=-1)
    return (x.astype(jnp.float32) * cos[..., None, :]
            + rot.astype(jnp.float32) * sin[..., None, :]).astype(x.dtype)


def _rotate_in(x: jax.Array, su: jax.Array, blocks: int = 1) -> jax.Array:
    """Incoherence rotation of activations: z = (x ⊙ SU) @ Ĥᵀ.

    blocks > 1 = block-diagonal rotation for row-parallel layers (rcp)."""
    return hadamard_transform_t(x * su, blocks=blocks).astype(x.dtype)


def _block_perm_in(z: jax.Array, nblocks: int) -> jax.Array:
    """tp-aware tcomb input permutation (AttnSpec.in_perm_o): original
    column blocks [0,2,4,...,1,3,5,...] of width n/nblocks — the layer was
    quantized against W[:, π] so each tensor-parallel shard's contiguous
    activation slice carries one KV1 and one KV2 piece.  Pure
    reshape/transpose."""
    N, n = z.shape
    tp = nblocks // 2
    return (z.reshape(N, tp, 2, n // nblocks).transpose(0, 2, 1, 3)
            .reshape(N, n))


_FLASH_MIN_CELLS = 1 << 22  # S*T above this -> blockwise attention


def _attention(q, k, v, offset, cfg: LlamaConfig):
    """q (B,S,h,d), k/v (B,T,hk,d); offset = global position of query 0
    (scalar, or (B,) per-row for continuous batching).

    Grouped-head einsums throughout (no jnp.repeat of KV).  Large S*T
    (long-context prefill / ppl eval) takes the blockwise flash path —
    the reference's plain SDPA (incoherent_linear.py:188-195) would
    materialize (B,h,S,T) f32 = 8.6 GB/layer at ctx 8192 (SURVEY §5.7)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    hk = cfg.num_kv_heads
    g = H // hk
    if S * T > _FLASH_MIN_CELLS:
        return _attention_flash(q, k, v, offset, cfg)
    qf = (q.astype(jnp.float32) * (D ** -0.5)).reshape(B, S, hk, g, D)
    logits = jnp.einsum("bskgd,btkd->bkgst", qf, k.astype(jnp.float32))
    mask = _causal_mask(S, T, offset)
    if mask.ndim == 2:
        logits = logits + mask[None, None, None, :, :]
    else:  # per-row mask (B, S, T)
        logits = logits + mask[:, None, None, :, :]
    p = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bkgst,btkd->bskgd", p, v.astype(jnp.float32))
    return out.reshape(B, S, H * D).astype(q.dtype)


def _attention_flash(q, k, v, offset, cfg: LlamaConfig,
                     qc: int = 512, tc: int = 512):
    """Blockwise softmax attention (flash-style): query chunks in an outer
    python loop (static — causality prunes whole KV chunks), KV chunks in
    an inner lax.scan carrying the running (max, denom, acc).  Peak live
    logits are (B, qc, hk, g, tc) f32 instead of (B, H, S, T)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    hk = cfg.num_kv_heads
    g = H // hk
    qc = next(c for c in (qc, 256, 128, 64, 32, 16, 8, 4, 2, 1)
              if S % c == 0)
    tc = next(c for c in (tc, 256, 128, 64, 32, 16, 8, 4, 2, 1)
              if T % c == 0)
    static_off = isinstance(offset, int)
    qf = (q.astype(jnp.float32) * (D ** -0.5)).reshape(B, S, hk, g, D)
    kc = k.reshape(B, T // tc, tc, hk, D)
    vc = v.reshape(B, T // tc, tc, hk, D)
    NEG = jnp.float32(-1e30)

    outs = []
    for qi in range(S // qc):
        qb = qf[:, qi * qc:(qi + 1) * qc]  # (B, qc, hk, g, D)
        if jnp.ndim(offset) == 1:  # per-row offsets (continuous batching)
            qpos = jnp.arange(qc)[None, :] + qi * qc + offset[:, None]
        else:
            qpos = jnp.arange(qc) + qi * qc + offset  # (qc,)
        if static_off:
            # causal: only KV chunks that intersect [0, q_end] matter
            n_kv = min(T // tc, (qi * qc + qc + offset + tc - 1) // tc)
        else:
            n_kv = T // tc

        def step(carry, it):
            m, l, acc = carry
            kb, vb, ti = it  # (B, tc, hk, D), (B, tc, hk, D), scalar
            lg = jnp.einsum("bskgd,btkd->bskgt", qb,
                            kb.astype(jnp.float32))  # (B, qc, hk, g, tc)
            kpos = ti * tc + jnp.arange(tc)
            if jnp.ndim(qpos) == 1:
                msk = kpos[None, :] <= qpos[:, None]  # (qc, tc)
                lg = jnp.where(msk[None, :, None, None, :], lg, NEG)
            else:
                msk = kpos[None, None, :] <= qpos[:, :, None]  # (B, qc, tc)
                lg = jnp.where(msk[:, :, None, None, :], lg, NEG)
            mb = jnp.maximum(m, jnp.max(lg, axis=-1))
            p = jnp.exp(lg - mb[..., None])
            alpha = jnp.exp(m - mb)
            l2 = l * alpha + jnp.sum(p, axis=-1)
            acc2 = (acc * alpha[..., None]
                    + jnp.einsum("bskgt,btkd->bskgd", p,
                                 vb.astype(jnp.float32)))
            return (mb, l2, acc2), None

        init = (jnp.full((B, qc, hk, g), NEG, jnp.float32),
                jnp.zeros((B, qc, hk, g), jnp.float32),
                jnp.zeros((B, qc, hk, g, D), jnp.float32))
        (m, l, acc), _ = jax.lax.scan(
            step, init, (kc[:, :n_kv].swapaxes(0, 1),
                         vc[:, :n_kv].swapaxes(0, 1), jnp.arange(n_kv)))
        outs.append(acc / jnp.maximum(l[..., None], 1e-30))
    out = jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, S, H * D).astype(q.dtype)


def attn_forward(spec: AttnSpec, cfg: LlamaConfig, p: dict, x: jax.Array,
                 cos, sin, kv_cache=None, cache_pos=None, offset=0,
                 luts=None, tp_axis=None):
    """x (B, S, hidden).  Returns (out, new_kv) where kv is (k, v) each
    (B, T, hk, d).

    Under a shard_map tensor-parallel forward (parallel/tp.py), cfg/spec are
    the per-device *local* versions (heads divided by tp) and tp_axis names
    the mesh axis for the o_proj partial-sum reduction."""
    B, S, N = x.shape
    rotated = spec.projs[0][1].kind != "dense"
    z = x.reshape(-1, N)
    if rotated:  # one rotation shared by the q/k/v projections
        z = _rotate_in(z, p["su_qkv"])
    outs = {}
    for name, lspec in spec.projs:
        if name != "o":
            outs[name] = qlinear_apply(lspec, p[name], z,
                                       luts).reshape(B, S, -1)
    # q width = heads*head_dim (== hidden when unsharded; the local value
    # under tensor parallelism), kv width analogous
    hs = cfg.num_heads * cfg.head_dim
    kv = cfg.kv_out
    if spec.merge == "qkv":
        q, k, v = jnp.split(outs["qkv"], [hs, hs + kv], axis=-1)
    elif spec.merge == "qk":
        q, k = jnp.split(outs["qk"], [hs], axis=-1)
        v = outs["v"]
    elif spec.merge == "kv":
        k, v = jnp.split(outs["kv"], [kv], axis=-1)
        q = outs["q"]
    elif spec.merge == "qv":
        q, v = jnp.split(outs["qv"], [hs], axis=-1)
        k = outs["k"]
    else:
        q, k, v = outs["q"], outs["k"], outs["v"]

    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    def _store(cache, val):
        """Write val (B, S, hk, d) at cache_pos (scalar or per-row (B,))."""
        if jnp.ndim(cache_pos) == 0:
            return jax.lax.dynamic_update_slice(
                cache, val.astype(cache.dtype), (0, cache_pos, 0, 0))
        # per-slot positions (continuous batching): scatter per row
        Bv, Sv = val.shape[:2]
        rows = jnp.repeat(jnp.arange(Bv), Sv)
        cols = (cache_pos[:, None]
                + jnp.arange(Sv)[None, :]).reshape(-1)
        return cache.at[rows, cols].set(
            val.astype(cache.dtype).reshape((Bv * Sv,) + val.shape[2:]))

    if kv_cache is not None and len(kv_cache) == 4:
        # int8-quantized KV cache (reference model/cache_utils.py
        # QuantizedCache zoo): per-(token, head) absmax scales
        ck, cks, cv, cvs = kv_cache

        def q8(x):
            s8 = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1,
                         keepdims=True) / 127.0 + 1e-8
            return (jnp.round(x.astype(jnp.float32) / s8)
                    .astype(jnp.int8), s8.astype(jnp.float32))

        k8, ks = q8(k)
        v8, vs = q8(v)
        ck = _store(ck, k8)
        cks = _store(cks, ks)
        cv = _store(cv, v8)
        cvs = _store(cvs, vs)
        k_full = (ck.astype(jnp.float32) * cks).astype(k.dtype)
        v_full = (cv.astype(jnp.float32) * cvs).astype(v.dtype)
        new_kv = (ck, cks, cv, cvs)
    elif kv_cache is not None:
        ck, cv = kv_cache  # (B, T, hk, d)
        ck = _store(ck, k)
        cv = _store(cv, v)
        k_full, v_full, new_kv = ck, cv, (ck, cv)
    else:
        k_full, v_full, new_kv = k, v, (k, v)

    att = _attention(q, k_full, v_full, offset, cfg)
    qw = att.shape[-1]  # heads*head_dim (local width under tp)
    oname, ospec = spec.projs[-1]
    assert oname == "o"
    z_o = att.reshape(-1, qw)
    if spec.in_perm_o:
        z_o = _block_perm_in(z_o, spec.in_perm_o)
    if rotated:
        z_o = _rotate_in(z_o, p["su_o"], spec.rot_blocks_o)
    out = qlinear_apply(ospec, p["o"], z_o, luts)
    out = out.reshape(B, S, N)
    if tp_axis is not None:  # row-parallel o_proj partial sums
        out = jax.lax.psum(out, tp_axis)
    return out, new_kv


def mlp_forward(spec: MLPSpec, cfg: LlamaConfig, p: dict, x: jax.Array,
                luts=None, tp_axis=None):
    B, S, N = x.shape
    I = cfg.intermediate_size  # local value under tensor parallelism
    rotated = spec.projs[0][1].kind != "dense"
    z = (_rotate_in(x.reshape(-1, N), p["su_ug"]) if rotated
         else x.reshape(-1, N))
    if spec.merge_ug:
        (_, ug_spec), (_, d_spec) = spec.projs
        y = qlinear_apply(ug_spec, p["ug"], z, luts)
        up, gate = y[:, :I], y[:, I:]
    else:
        (_, u_spec), (_, g_spec), (_, d_spec) = spec.projs
        up = qlinear_apply(u_spec, p["up"], z, luts)
        gate = qlinear_apply(g_spec, p["gate"], z, luts)
    h = jax.nn.silu(gate.astype(jnp.float32)) * up.astype(jnp.float32)
    h = h.astype(x.dtype)
    if spec.in_perm_down:
        h = _block_perm_in(h, spec.in_perm_down)
    if rotated:
        h = _rotate_in(h, p["su_dp"], spec.rot_blocks_down)
    out = qlinear_apply(d_spec, p["down"], h, luts)
    if tp_axis is not None:  # row-parallel down_proj partial sums
        out = jax.lax.psum(out, tp_axis)
    return out.reshape(B, S, N)


def _causal_mask(S: int, T: int, offset) -> jax.Array:
    """Additive mask: query i (global pos offset+i) sees keys <= its pos.

    offset may be scalar or per-row (B,) (continuous batching); result is
    (S, T) or (B, S, T)."""
    if jnp.ndim(offset) == 0:
        q = jax.lax.broadcasted_iota(jnp.int32, (S, T), 0) + offset
        kpos = jax.lax.broadcasted_iota(jnp.int32, (S, T), 1)
        return jnp.where(kpos <= q, 0.0, -1e30).astype(jnp.float32)
    q = (jax.lax.broadcasted_iota(jnp.int32, (S, T), 0)[None]
         + offset[:, None, None])
    kpos = jax.lax.broadcasted_iota(jnp.int32, (S, T), 1)[None]
    return jnp.where(kpos <= q, 0.0, -1e30).astype(jnp.float32)


def forward(spec: ModelSpec, params: Params, tokens: jax.Array,
            kv_caches=None, cache_pos=None, return_hidden: bool = False):
    """tokens (B, S) -> logits (B, S, vocab).

    With kv_caches (list per layer of (k, v) (B, T, hk, d)) runs the
    incremental decode path, writing at cache_pos.  return_hidden=True
    returns the final-norm hidden states instead of logits (long-context
    CE chunks the lm_head matmul itself — (B, S, vocab) f32 at ctx 8192
    is 4.2 GB).
    """
    cfg = spec.config
    B, S = tokens.shape
    x = jnp.take(params["embed"], tokens, axis=0).astype(cfg.dtype)
    offset = cache_pos if kv_caches is not None else 0
    if jnp.ndim(offset) == 1:
        pos = jnp.arange(S)[None, :] + offset[:, None]
    else:
        pos = jnp.arange(S)[None, :] + offset
    cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta)

    luts = params.get("luts", {})
    new_caches = []
    for li, (aspec, mspec) in enumerate(spec.layers):
        lp = params["layers"][li]
        h = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
        a, kv = attn_forward(aspec, cfg, lp, h, cos, sin,
                             kv_cache=None if kv_caches is None
                             else kv_caches[li],
                             cache_pos=cache_pos, offset=offset, luts=luts,
                             tp_axis=spec.tp_axis)
        x = x + a
        h = rms_norm(x, lp["ln_mlp"], cfg.rms_eps)
        x = x + mlp_forward(mspec, cfg, lp, h, luts=luts,
                            tp_axis=spec.tp_axis)
        new_caches.append(kv)

    x = rms_norm(x, params["ln_f"], cfg.rms_eps)
    if return_hidden:
        return (x, new_caches) if kv_caches is not None else x
    if spec.lm_head_spec is not None:
        # quantized-trellis lm_head (4-bit tcq2s): same qlinear path as
        # the decoder projections; vocab padded to 2^17, sliced back here.
        # out_dtype=f32: final logits skip the decoder layers' bf16
        # round-trip, matching the int8 head's f32 epilogue
        xf = _rotate_in(x.reshape(-1, cfg.hidden_size),
                        params["lm_head_su"].astype(x.dtype))
        logits = qlinear_apply(spec.lm_head_spec, params["lm_head_q4"], xf,
                               luts, out_dtype=jnp.float32)
        logits = logits[:, :cfg.vocab_size]
        logits = logits.reshape(B, S, cfg.vocab_size)
    elif "lm_head_q" in params:
        # int8 per-row-quantized lm_head, stored (k, vocab padded to a
        # 2048 multiple) with an incoherence rotation (loader stores
        # lm_head_su).  int8 -> activation dtype is exact; the per-column
        # scales apply in the f32 epilogue.
        xf = x.reshape(-1, cfg.hidden_size)
        if "lm_head_su" in params:
            xf = _rotate_in(xf, params["lm_head_su"].astype(xf.dtype))
        logits = jax.lax.dot_general(
            xf, params["lm_head_q"].astype(xf.dtype),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        logits = logits * params["lm_head_s"].astype(jnp.float32)
        logits = logits[:, :cfg.vocab_size]
        logits = logits.reshape(B, S, cfg.vocab_size)
    else:
        logits = (x.astype(jnp.float32)
                  @ params["lm_head"].T.astype(jnp.float32))
    if kv_caches is not None:
        return logits, new_caches
    return logits


def init_kv_caches(spec: ModelSpec, batch: int, max_seq: int,
                   quantized: bool = False):
    """Preallocated KV caches; quantized=True uses int8 values + f32
    per-(token, head) scales (half the bytes of bf16 — the reference's
    QuantizedCache analogue)."""
    cfg = spec.config
    shp = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    sshp = (batch, max_seq, cfg.num_kv_heads, 1)
    if quantized:
        return [
            (jnp.zeros(shp, jnp.int8), jnp.ones(sshp, jnp.float32),
             jnp.zeros(shp, jnp.int8), jnp.ones(sshp, jnp.float32))
            for _ in range(cfg.num_layers)
        ]
    return [
        (jnp.zeros(shp, cfg.dtype), jnp.zeros(shp, cfg.dtype))
        for _ in range(cfg.num_layers)
    ]
