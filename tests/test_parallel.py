"""Sharding tests on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qpalette_tpu.models.llama import LlamaConfig, forward
from qpalette_tpu.parallel.sharding import (make_mesh, param_shardings,
                                            shard_params)
from qpalette_tpu.runtime.loader import build_quantized_model


CFG = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_layers=2, num_heads=8, num_kv_heads=4, head_dim=32,
                  rope_theta=10000.0)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_forward_matches_single_device(tmp_path):
    spec, params = build_quantized_model(
        CFG, "tcq_4_none_0.9", model_key="tiny_tp",
        save_dir=str(tmp_path), dummy=True)
    toks = jnp.asarray(np.arange(16).reshape(2, 8) % CFG.vocab_size,
                       jnp.int32)
    ref = np.asarray(forward(spec, params, toks))

    mesh = make_mesh(8, tp=4)
    sparams = shard_params(params, mesh)
    out = np.asarray(jax.jit(
        lambda p, t: forward(spec, p, t))(sparams, toks))
    assert np.allclose(out, ref, atol=2e-2), np.abs(out - ref).max()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_param_shardings_cover_all_leaves(tmp_path):
    spec, params = build_quantized_model(
        CFG, "ldlq_2_4_none_1.0", model_key="tiny_tp2",
        save_dir=str(tmp_path), dummy=True)
    mesh = make_mesh(8, tp=2)
    sh = param_shardings(params, mesh)
    jax.tree.map(lambda x, s: None, params, sh)  # same structure

    sparams = shard_params(params, mesh)
    # packed words must actually be split over tp along output rows
    lp = sparams["layers"][0]
    q = lp["q"]["qweight_t"]  # (words, m)
    shard_shapes = {tuple(s.data.shape) for s in q.addressable_shards}
    assert all(ss[1] == q.shape[1] // 2 for ss in shard_shapes)


@pytest.mark.slow  # 175 s; duplicates the driver's own dryrun gate
def test_dryrun_entry():
    import __graft_entry__ as ge
    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)


def test_graft_entry_compiles():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


# ---------------------------------------------------------------------------
# shard_map tensor-parallel path (parallel/tp.py): col qkv/ug + row o/down
# with block-diagonal rcp rotations
# ---------------------------------------------------------------------------

@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("qstr,impl", [
    pytest.param("tcq1_3_none_0.9", "pallas", marks=pytest.mark.slow),
    ("mixed", "pallas"),  # VQ col-parallel + tcq1 row-parallel
])
def test_tp_shardmap_matches_single_device(tmp_path, qstr, impl):
    from qpalette_tpu.parallel import tp as tpmod
    from qpalette_tpu.runtime.loader import LAYER_KEYS

    TPN = 4
    if qstr == "mixed":
        # per-proj mix like an MSQ solution; o/down use tcq1 (VQ's packed
        # word dim at this tiny shape is not divisible by tp)
        qd = {}
        for i in range(CFG.num_layers):
            for key in LAYER_KEYS:
                qd[f"{i}_{key}"] = ("tcq1_3_none_0.9"
                                    if key in ("self_attn.o_proj",
                                               "mlp.down_proj")
                                    else "ldlq_2_4_none_1.0")
    else:
        qd = qstr
    spec, params = build_quantized_model(
        CFG, qd, model_key=f"tiny_rcp_{qstr[:6]}",
        save_dir=str(tmp_path), dummy=True, impl=impl,
        row_parallel_tp=TPN)
    toks = jnp.asarray(np.arange(16).reshape(2, 8) % CFG.vocab_size,
                       jnp.int32)
    # single-device reference: same model, block-diagonal rotations applied
    # unsharded (rot_blocks on the spec drive _rotate_in)
    ref = np.asarray(forward(spec, params, toks))

    mesh = make_mesh(TPN, tp=TPN)
    sparams = tpmod.shard_tp_params(params, spec, mesh)
    fwd = tpmod.tp_forward_fn(spec, mesh, params)
    out = np.asarray(fwd(sparams, toks))
    assert np.allclose(out, ref, atol=2e-2), np.abs(out - ref).max()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.slow  # 319 s interpret-mode
def test_tp_shardmap_merged_tcq2s_bench_mix(tmp_path):
    """The FLAGSHIP bench config under tensor parallelism: merged qkv/ug
    (column-parallel via shard-interleaved m-tiles) + tcq2s everywhere
    with row-parallel o/down (k-tile split of the trellis layout)."""
    from qpalette_tpu.parallel import tp as tpmod
    from qpalette_tpu.runtime.loader import LAYER_KEYS

    TPN = 4
    qd = {}
    for i in range(CFG.num_layers):
        for key in LAYER_KEYS:
            qd[f"{i}_{key}"] = ("tcq2s_8_none_0.9"
                                if key == "mlp.down_proj"
                                else "tcq2s_6_none_0.9")
    mi = [["merge_qkv", "merge_ug"]] * CFG.num_layers
    spec, params = build_quantized_model(
        CFG, qd, merge_info=mi, model_key="tiny_tp_sum2",
        save_dir=str(tmp_path), dummy=True, impl="pallas",
        row_parallel_tp=TPN)
    toks = jnp.asarray(np.arange(16).reshape(2, 8) % CFG.vocab_size,
                       jnp.int32)
    ref = np.asarray(forward(spec, params, toks))

    mesh = make_mesh(TPN, tp=TPN)
    sparams = tpmod.shard_tp_params(params, spec, mesh)
    fwd = tpmod.tp_forward_fn(spec, mesh, params)
    out = np.asarray(fwd(sparams, toks))
    assert np.allclose(out, ref, atol=2e-2), np.abs(out - ref).max()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.slow  # 101 s
def test_tp_shardmap_decode_cache(tmp_path):
    from qpalette_tpu.parallel import tp as tpmod
    from qpalette_tpu.models.llama import init_kv_caches
    from jax.sharding import NamedSharding

    TPN = 4
    spec, params = build_quantized_model(
        CFG, "tcq1_3_none_0.9", model_key="tiny_rcp_dec",
        save_dir=str(tmp_path), dummy=True, impl="pallas",
        row_parallel_tp=TPN)
    toks = jnp.asarray(np.arange(2).reshape(2, 1), jnp.int32)
    caches = init_kv_caches(spec, 2, 8)
    ref_logits, ref_caches = forward(spec, params, toks,
                                     kv_caches=caches, cache_pos=0)

    mesh = make_mesh(TPN, tp=TPN)
    sparams = tpmod.shard_tp_params(params, spec, mesh)
    cs = NamedSharding(mesh, tpmod.kv_cache_pspec())
    scaches = [tuple(jax.device_put(c, cs) for c in kv) for kv in caches]
    fwd = tpmod.tp_forward_fn(spec, mesh, params, with_cache=True)
    out, new_caches = fwd(sparams, toks, scaches, jnp.int32(0))
    assert np.allclose(np.asarray(out), np.asarray(ref_logits), atol=2e-2)
    # cache contents must match the reference too
    for (rk, rv), (nk, nv) in zip(ref_caches, new_caches):
        assert np.allclose(np.asarray(nk), np.asarray(rk), atol=2e-2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.slow  # interpret-mode tcomb forward
def test_tp_shardmap_tcomb_quality_flagship(tmp_path):
    """Row-parallel TP for the INPUT-SPLIT tcomb scheme (round-4 VERDICT
    #7): the committed 3.25-bit quality flagship (all-tcomb, tcomb_6_7)
    under the rcp shard_map path.  o/down are quantized in the tp-aware
    block-permuted space (loader in_perm_blocks=2*tp) so each shard's
    contiguous activation slice carries one KV1 and one KV2 piece;
    placement interleaves the packed k-tiles shard-major."""
    from qpalette_tpu.parallel import tp as tpmod
    from qpalette_tpu.runtime.loader import LAYER_KEYS

    TPN = 4
    qd = {f"{i}_{key}": "tcomb_6_7_0.5_none_0.9"
          for i in range(CFG.num_layers) for key in LAYER_KEYS}
    spec, params = build_quantized_model(
        CFG, qd, model_key="tiny_tp_tcomb",
        save_dir=str(tmp_path), dummy=True, impl="pallas",
        row_parallel_tp=TPN)
    aspec0, mspec0 = spec.layers[0]
    assert aspec0.in_perm_o == 2 * TPN and aspec0.rot_blocks_o == 2 * TPN
    assert mspec0.in_perm_down == 2 * TPN
    toks = jnp.asarray(np.arange(16).reshape(2, 8) % CFG.vocab_size,
                       jnp.int32)
    ref = np.asarray(forward(spec, params, toks))

    mesh = make_mesh(TPN, tp=TPN)
    sparams = tpmod.shard_tp_params(params, spec, mesh)
    fwd = tpmod.tp_forward_fn(spec, mesh, params)
    out = np.asarray(fwd(sparams, toks))
    assert np.allclose(out, ref, atol=2e-2), np.abs(out - ref).max()
