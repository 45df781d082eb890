"""Tensor-parallel forward via shard_map: Megatron-style col/row split.

Reference behavior being replaced: the reference's vestigial TP hooks — the
`rcp`/`tp_rank` buffers of QuantizedLinear (lib/linear/quantized_linear.py:
42-44) and the rcp-conditional Hadamard reshapes (lib/codebook/
bitshift.py:374-388, lib/utils/data_utils.py:287-308) — which document how
incoherence rotations must compose with row/col weight sharding but are
never driven by any collective.  Here the whole decoder layer runs under
``jax.shard_map`` over a tp mesh axis with XLA collectives (NCCL over
NVLink on a multi-GPU host):

  * q/k/v, up/gate: column-parallel (output rows sharded; the shared input
    rotation sees replicated activations — rotation math unchanged).
  * o, down: row-parallel (input dim sharded).  Their quantization-time
    input rotation is block-diagonal I_tp ⊗ Ĥ_{n/tp} (quantize_linear
    rot_blocks=tp), so each device rotates its local activation shard with
    a full local Hadamard — zero communication — and the partial outputs
    are psum'd.  This is exactly the reference's `rcp=1` case.
  * attention runs on local heads (head-sharded KV cache).

Per token this costs 2 psums/layer (o, down) instead of the 2 activation
all-gathers of the naive everything-column-parallel scheme, and every
weight byte is read by exactly one chip.

Merged projections (fused qkv / ug) ARE column-parallel-shardable: the
merged weight is a row-concat [Wq; Wk; Wv], and shard s needs rows
[q_s | k_s | v_s] — a non-contiguous slice of the merged row order.  We
pre-permute the m-tile axis of the packed arrays once at placement time
(shard_interleave_merged) so each shard's rows are contiguous, after which
a plain PartitionSpec over the tile axis is correct and the local forward's
split points (local hs / kv widths) line up.  This realizes the row-concat
merge semantics of the reference (tcq_linear.merge_infos) under sharding.

Input-split tcomb (the 3.25-bit quality flagship's scheme) IS row-parallel
shardable: the loader quantizes o/down-tcomb against the block-permuted
W[:, π] (in_perm_blocks = 2·tp, π = original blocks [0,2,...,1,3,...]) so
each shard's contiguous activation slice holds one KV1 and one KV2 piece;
each half's packed k-tiles shard natively, the permuted-space SU is
interleaved shard-major (shard_interleave_tcomb_rows), and each shard runs
a local tcomb with in_part/tp and a 2-block local rotation.  Output-split
comb shards natively (both output halves see the full k split).

Constraints (asserted): heads, kv-heads and intermediate divisible by tp
(and each merged part's tile count by tp); the (k/16, words, m/16) trellis
layout splits cleanly on k-tile boundaries because every 16x16 tile's
bitstream is self-contained.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qpalette_tpu.models import llama
from qpalette_tpu.models.llama import (AttnSpec, LlamaConfig, MLPSpec,
                                       ModelSpec)

TRELLIS_LEAVES = ("trellis_kt", "trellis1_kt", "trellis2_kt")
COL_PROJS = ("q", "k", "v", "up", "gate")
ROW_PROJS = ("o", "down")
MERGED_PROJS = ("qkv", "qk", "kv", "qv", "ug")


def _merged_parts(cfg: LlamaConfig, name: str):
    """Output-row widths of a merged projection's parts (loader order)."""
    hs = cfg.num_heads * cfg.head_dim
    kv = cfg.kv_out
    I = cfg.intermediate_size
    return {"qkv": (hs, kv, kv), "qk": (hs, kv), "kv": (kv, kv),
            "qv": (hs, kv), "ug": (I, I)}[name]


def _shard_interleave(counts, tp: int) -> np.ndarray:
    """Permutation over sum(counts) positions: concat-of-parts order ->
    shard-major order (shard s gets part_i[s*ci/tp:(s+1)*ci/tp] for all i,
    contiguously)."""
    offs = np.cumsum([0] + list(counts[:-1]))
    out = []
    for s in range(tp):
        for c, o in zip(counts, offs):
            assert c % tp == 0, (counts, tp)
            step = c // tp
            out.extend(range(o + s * step, o + (s + 1) * step))
    return np.asarray(out, np.int64)


def _scale_linear_spec(lspec, tp: int, row: bool):
    """LinearSpec -> per-device local LinearSpec."""
    from qpalette_tpu.runtime.qlinear import LinearSpec
    d = dataclasses.asdict(lspec)
    if row:
        assert lspec.kind in ("tcq", "tcq1", "tcq2", "vq", "dense",
                              "dense_rot", "tcomb", "comb"), \
            f"row-parallel unsupported for scheme {lspec.kind}"
        assert lspec.in_features % tp == 0
        if lspec.kind == "tcomb":
            # input-split halves shard together: the layer was quantized
            # in the tp-aware block-permuted space (loader in_perm_blocks)
            # and placement interleaves the packed k-tiles shard-major, so
            # each shard runs a local tcomb with in_part/tp
            n1, n2 = lspec.split
            assert n1 % (16 * tp) == 0 and n2 % (16 * tp) == 0, (n1, n2, tp)
            d["split"] = (n1 // tp, n2 // tp)
        if lspec.kind == "vq":
            # each shard's index bitstream must start on a word boundary
            lbits = lspec.in_features // tp // lspec.vec * lspec.bits
            assert lbits % 32 == 0, (
                f"VQ row-parallel needs (k/tp/vec*bits) % 32 == 0 "
                f"(got {lbits} bits per shard for tp={tp})")
        d["in_features"] = lspec.in_features // tp
    else:
        assert lspec.out_features % tp == 0
        d["out_features"] = lspec.out_features // tp
        if lspec.kind == "comb":  # output-split halves shard together
            m1, m2 = lspec.split
            assert m1 % tp == 0 and m2 % tp == 0
            d["split"] = (m1 // tp, m2 // tp)
    return LinearSpec(**d)


def localize_spec(spec: ModelSpec, tp: int, axis: str = "tp") -> ModelSpec:
    """Global ModelSpec -> the per-device spec seen inside shard_map."""
    cfg = spec.config
    assert cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0, (
        f"tp={tp} must divide num_heads={cfg.num_heads} and "
        f"num_kv_heads={cfg.num_kv_heads}")
    assert cfg.intermediate_size % tp == 0, (
        f"tp={tp} must divide intermediate_size={cfg.intermediate_size}")
    lcfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)
    layers = []
    for aspec, mspec in spec.layers:
        assert aspec.rot_blocks_o % tp == 0 and \
            mspec.rot_blocks_down % tp == 0, (
            "row-parallel layers must be quantized with rot_blocks=tp "
            "(2*tp for input-split tcomb) "
            f"(got o={aspec.rot_blocks_o}, down={mspec.rot_blocks_down})")
        aprojs = tuple(
            (nm, _scale_linear_spec(ls, tp, row=(nm == "o")))
            for nm, ls in aspec.projs)
        mprojs = tuple(
            (nm, _scale_linear_spec(ls, tp, row=(nm == "down")))
            for nm, ls in mspec.projs)
        # local rotation = full Hadamard of the local shard width (2
        # blocks for tcomb's per-shard KV1/KV2 pieces); the global
        # in_perm block permutation is identity locally — each shard's
        # contiguous slice already arrives [KV1 piece | KV2 piece]
        layers.append((AttnSpec(aspec.merge, aprojs,
                                rot_blocks_o=aspec.rot_blocks_o // tp,
                                in_perm_o=0),
                       MLPSpec(mspec.merge_ug, mprojs,
                               rot_blocks_down=mspec.rot_blocks_down // tp,
                               in_perm_down=0)))
    return ModelSpec(lcfg, tuple(layers), tp_axis=axis)


def _leaf_pspec(proj: str, leaf: str, ndim: int, axis: str) -> P:
    """PartitionSpec for one param leaf of one projection."""
    row = proj in ROW_PROJS
    if leaf == "wscale":
        return P() if row else P(axis)
    if leaf in TRELLIS_LEAVES:
        # (k/16, words, m/16): row-parallel shards k-tiles, col shards m
        return P(axis, None, None) if row else P(None, None, axis)
    if leaf == "qweight_t":  # (words over k, m)
        return P(axis, None) if row else P(None, axis)
    if leaf == "w":  # dense (m, n)
        return P(None, axis) if row else P(axis, None)
    return P()  # lut


def param_pspecs(spec: ModelSpec, params, axis: str = "tp"):
    """PartitionSpec pytree for a quantized-model params pytree."""
    def layer_specs(lp):
        out = {}
        for k, v in lp.items():
            if k in ("su_o",):
                out[k] = P(axis)
            elif k == "su_dp":
                out[k] = P(axis)
            elif isinstance(v, dict):  # projection param group
                out[k] = {leaf: _leaf_pspec(k, leaf, getattr(a, "ndim", 0),
                                            axis)
                          for leaf, a in v.items()}
            else:  # su_qkv, su_ug, ln_*
                out[k] = P()
        return out

    pspecs = {"layers": [layer_specs(lp) for lp in params["layers"]],
              "luts": {k: P() for k in params.get("luts", {})}}
    # replicated lm_head variants: bf16 (lm_head), int8 (lm_head_q/_s) and
    # 4-bit trellis (lm_head_q4 leaf dict) — all small relative to the
    # decoder stack; shard later if profiling demands
    for k in ("embed", "lm_head", "ln_f", "lm_head_q", "lm_head_s",
              "lm_head_su"):
        if k in params:
            pspecs[k] = P()
    if "lm_head_q4" in params:
        pspecs["lm_head_q4"] = {leaf: P() for leaf in params["lm_head_q4"]}
    return pspecs


def _permute_merged_leaf(leaf: str, arr, perm1, perm16):
    """Reorder a merged projection's output rows into shard-major order."""
    if leaf == "wscale":
        return arr[perm1]
    if leaf in TRELLIS_LEAVES:
        return arr[:, :, perm16]          # (k/16, words, m/16)
    if leaf == "qweight_t":
        return arr[:, perm1]              # (words, m)
    if leaf == "w":
        return arr[perm1]                 # dense (m, n)
    return arr  # lut


def shard_interleave_merged(params, spec: ModelSpec, tp: int):
    """Pre-permute merged projections' m-tiles to shard-major order so a
    plain PartitionSpec over the tile axis gives each shard contiguous
    [q_s | k_s | v_s] rows (see module docstring)."""
    cfg = spec.config
    out_layers = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for name in MERGED_PROJS:
            if name not in nlp:
                continue
            parts = _merged_parts(cfg, name)
            perm1 = _shard_interleave(parts, tp)
            perm16 = _shard_interleave([p // 16 for p in parts], tp)
            nlp[name] = {leaf: _permute_merged_leaf(leaf, a, perm1, perm16)
                         for leaf, a in nlp[name].items()}
        out_layers.append(nlp)
    return dict(params, layers=out_layers)


def shard_interleave_tcomb_rows(params, spec: ModelSpec, tp: int):
    """Row-parallel input-split tcomb: reorder the permuted-space SU
    vector shard-major so a plain PartitionSpec gives each shard its
    [KV1-slice | KV2-slice] signs — matching the contiguous activation
    slice order the loader's in_perm_blocks quantization arranged
    (reference rcp semantics for the split schemes, bitshift.py:374-388).
    The two packed halves shard natively on their k-tile axes."""
    out_layers = []
    for lp, (aspec, mspec) in zip(params["layers"], spec.layers):
        nlp = dict(lp)
        for proj, su_key, perm in (("o", "su_o", aspec.in_perm_o),
                                   ("down", "su_dp", mspec.in_perm_down)):
            if not perm or proj not in nlp:
                continue
            n = nlp[su_key].shape[0]
            pe = _shard_interleave([n // 2, n // 2], tp)
            nlp[su_key] = nlp[su_key][pe]
        out_layers.append(nlp)
    return dict(params, layers=out_layers)


def shard_tp_params(params, spec: ModelSpec, mesh: Mesh, axis: str = "tp"):
    tp = mesh.shape[axis]
    if tp > 1:
        params = shard_interleave_merged(params, spec, tp)
        params = shard_interleave_tcomb_rows(params, spec, tp)
    pspecs = param_pspecs(spec, params, axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        params, pspecs, is_leaf=lambda x: isinstance(x, P))


def kv_cache_pspec(axis: str = "tp") -> P:
    return P(None, None, axis, None)


def tp_forward_fn(spec: ModelSpec, mesh: Mesh, params, axis: str = "tp",
                  with_cache: bool = False):
    """Build a jit-able tensor-parallel forward over `mesh`.

    Returns fn(params, tokens [, kv_caches, cache_pos]) operating on
    globally-sharded arrays (placed by shard_tp_params /
    NamedSharding(kv_cache_pspec)).
    """
    tp = mesh.shape[axis]
    lspec = localize_spec(spec, tp, axis)
    pspecs = param_pspecs(spec, params, axis)

    if not with_cache:
        def body(params, tokens):
            return llama.forward(lspec, params, tokens)

        return jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(pspecs, P()), out_specs=P(),
            check_vma=False))

    def body(params, tokens, kv_caches, cache_pos):
        return llama.forward(lspec, params, tokens, kv_caches=kv_caches,
                             cache_pos=cache_pos)

    nlayer = spec.config.num_layers
    kvspec = [(kv_cache_pspec(axis), kv_cache_pspec(axis))
              for _ in range(nlayer)]
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(pspecs, P(), kvspec, P()),
        out_specs=(P(), kvspec), check_vma=False))
