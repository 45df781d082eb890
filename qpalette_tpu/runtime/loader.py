"""Model assembly: qdict + artifacts -> (ModelSpec, params).

Reference behavior:
  - eval_qdict.load_model (:41-71): per layer×proj, quantize-on-demand if
    the artifact is missing, then swap in the incoherent quantized linear.
  - measure_latency.load_quant_model (:23-100): same plus merge_info-driven
    QKV/gate-up fusion and --dummy random-weight mode
    (lib/utils/mem_op.py:198-269).
  - merge_infos row-concat semantics: lib/linear/incoherent_linear.py:232-248,
    tcq_linear.py gen_layer_from_info/merge_infos (:86-122).

The qdict maps "{layer}_{key}" -> quantizer_str (or (quantizer_str, simt)
tuples, where the reference's kernel-variant flag selects between the
decode-GEMV kernel and the XLA dequant path here).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from qpalette_tpu.models.llama import (AttnSpec, LlamaConfig, MLPSpec,
                                       ModelSpec)
from qpalette_tpu.ops.codebooks import trellis_lut, vq_lut, tlut_bits_for_kv
from qpalette_tpu.quant.incoherent import (artifact_path, load_artifact,
                                           parse_quantizer_str,
                                           quantize_linear, save_artifact)
from qpalette_tpu.runtime.qlinear import LinearSpec, resolve_impl

LAYER_KEYS = [
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
]

MODEL_KEYS = {  # reference lib/config.py
    "meta-llama/Llama-3.1-8B": "3_8b",
    "meta-llama/Llama-3.2-1B": "3_1b",
    "meta-llama/Llama-3.2-3B": "3_3b",
    "meta-llama/Llama-2-7b-hf": "2_7b",
}

CONFIGS = {
    "3_8b": LlamaConfig.llama31_8b,
    "3_1b": LlamaConfig.llama32_1b,
    "3_3b": LlamaConfig.llama32_3b,
}


def proj_shape(cfg: LlamaConfig, key: str):
    h, i, kv = cfg.hidden_size, cfg.intermediate_size, cfg.kv_out
    return {
        "self_attn.q_proj": (h, h), "self_attn.k_proj": (kv, h),
        "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, h),
        "mlp.gate_proj": (i, h), "mlp.up_proj": (i, h),
        "mlp.down_proj": (h, i),
    }[key]


def su_for(cfg: LlamaConfig, layer: int, key: str, seed: int) -> np.ndarray:
    """Deterministic shared sign vectors (reference cache_random_signs,
    quantize_layer.py:150-181: q/k/v share, up/gate share)."""
    group = {"self_attn.q_proj": "qkv", "self_attn.k_proj": "qkv",
             "self_attn.v_proj": "qkv", "self_attn.o_proj": "o",
             "mlp.gate_proj": "ug", "mlp.up_proj": "ug",
             "mlp.down_proj": "dp"}[key]
    n = proj_shape(cfg, key)[1]
    gid = {"qkv": 0, "o": 1, "ug": 2, "dp": 3}[group]
    rng = np.random.default_rng(seed * 1000003 + layer * 101 + gid)
    return (rng.standard_normal(n) > 0).astype(np.float32) * 2.0 - 1.0


# ---------------------------------------------------------------------------
# artifact -> (LinearSpec, param arrays)
# ---------------------------------------------------------------------------

def _spec_from_meta(meta: dict, impl: str) -> LinearSpec:
    kind = meta["kind"]
    common = dict(in_features=meta["in_features"],
                  out_features=meta["out_features"],
                  impl=resolve_impl(kind, impl))
    if kind == "tcq":
        return LinearSpec("tcq", KV=(meta["KV"],),
                          tlut_bits=meta["tlut_bits"], **common)
    if kind in ("tcq1", "tcq2"):
        return LinearSpec(kind, KV=(meta["KV"],),
                          mode=meta["decode_mode"], **common)
    if kind == "tcomb":
        return LinearSpec("tcomb", KV=(meta["KV1"], meta["KV2"]),
                          tlut_bits=meta["tlut_bits"],
                          split=tuple(meta["in_part"]), **common)
    if kind == "comb":
        return LinearSpec("comb", KV=(meta["KV1"], meta["KV2"]),
                          tlut_bits=meta["tlut_bits"],
                          split=tuple(meta["out_part"]), **common)
    if kind == "vq":
        return LinearSpec("vq", bits=meta["bits"], vec=meta["vec"], **common)
    if kind == "dense_rot":
        return LinearSpec("dense_rot", **common)
    raise ValueError(kind)


def _rand_u32(key, shape):
    return jax.random.bits(key, shape, jnp.uint32)


def _params_from_artifact(art: dict, dtype) -> dict:
    """Artifact -> device params in the kind's one layout
    (kernels/formats.py), read by every impl."""
    from qpalette_tpu.kernels import formats as kf
    meta = art["meta"]
    p = {"wscale": jnp.asarray(art["Wscale"], jnp.float32)}
    kind = meta["kind"]
    m, n = meta["out_features"], meta["in_features"]
    V = 1 if kind == "tcq1" else 2
    if art.get("__device_dummy__") is not None:
        # dummy latency mode: random packed bits generated on the device
        key = jax.random.PRNGKey(int(art["__device_dummy__"]))
        if kind in ("tcq", "tcq1", "tcq2"):
            p["trellis_kt"] = _rand_u32(key, (
                n // 16, kf.trellis_words_per_tile(meta["KV"], V), m // 16))
        elif kind in ("tcomb", "comb"):
            m1, m2 = meta["out_part"] if kind == "comb" else (m, m)
            n1, n2 = meta["in_part"] if kind == "tcomb" else (n, n)
            k1, k2 = jax.random.split(key)
            p["trellis1_kt"] = _rand_u32(k1, (
                n1 // 16, kf.trellis_words_per_tile(meta["KV1"], 2), m1 // 16))
            p["trellis2_kt"] = _rand_u32(k2, (
                n2 // 16, kf.trellis_words_per_tile(meta["KV2"], 2), m2 // 16))
        elif kind == "vq":
            bits, vec = meta["bits"], meta["vec"]
            p["qweight_t"] = _rand_u32(key, ((n // vec) * bits // 32, m))
            p["lut"] = jnp.asarray(vq_lut(bits, vec), dtype)
        else:
            raise ValueError(kind)
        return p
    if kind == "dense_rot":
        p["w"] = jnp.asarray(art["w"], dtype)
    elif kind in ("tcq", "tcq1", "tcq2"):
        p["trellis_kt"] = kf.trellis_kt(art["trellis"], m, n)
    elif kind == "tcomb":
        n1, n2 = meta["in_part"]
        p["trellis1_kt"] = kf.trellis_kt(art["trellis1"], m, n1)
        p["trellis2_kt"] = kf.trellis_kt(art["trellis2"], m, n2)
    elif kind == "comb":
        m1, m2 = meta["out_part"]
        p["trellis1_kt"] = kf.trellis_kt(art["trellis1"], m1, n)
        p["trellis2_kt"] = kf.trellis_kt(art["trellis2"], m2, n)
    elif kind == "vq":
        p["qweight_t"] = kf.vq_words(art["qweight"], meta["bits"],
                                     meta["vec"], n)
        p["lut"] = jnp.asarray(art["lut"] if "lut" in art
                               else vq_lut(meta["bits"], meta["vec"]), dtype)
    else:
        raise ValueError(kind)
    return p


def merge_artifacts(arts: list) -> dict:
    """Row-concat merge of same-scheme artifacts (fused qkv / ug layers).

    Mirrors {QTIPLinearTCQ,VQLinearPack*,CombtLinearTCQ}.merge_infos —
    trellis/qweight rows concatenate because tiles are stored tile-row-major
    with a shared in_features; Wscale concatenates; SU must already be
    shared (same rotation for all merged projections).
    """
    m0 = arts[0]["meta"]
    kind = m0["kind"]
    for a in arts[1:]:
        assert a["meta"]["kind"] == kind, "can only merge same scheme"
        assert a["meta"]["in_features"] == m0["in_features"]
        assert np.array_equal(a["SU"], arts[0]["SU"]), "merge needs shared SU"
    out = {
        "meta": dict(m0, out_features=sum(a["meta"]["out_features"]
                                          for a in arts)),
        "SU": arts[0]["SU"],
        "Wscale": np.concatenate([a["Wscale"] for a in arts]),
    }
    if all(a.get("__device_dummy__") is not None for a in arts):
        out["__device_dummy__"] = arts[0]["__device_dummy__"]
        return out
    if kind == "tcq":
        assert all(a["meta"]["KV"] == m0["KV"] for a in arts)
        out["trellis"] = np.concatenate([a["trellis"] for a in arts], axis=0)
        if arts[0].get("tlut") is not None:
            out["tlut"] = arts[0]["tlut"]
    elif kind in ("tcq1", "tcq2"):
        # same tile-row-major concat as tcq: trellis rows are (m/16)*(n/16)
        # tiles ordered m-major, so stacking artifacts stacks output rows
        assert all(a["meta"]["KV"] == m0["KV"] for a in arts)
        assert all(a["meta"]["decode_mode"] == m0["decode_mode"]
                   for a in arts)
        out["trellis"] = np.concatenate([a["trellis"] for a in arts], axis=0)
    elif kind == "tcomb":
        assert all(a["meta"]["KV1"] == m0["KV1"]
                   and a["meta"]["KV2"] == m0["KV2"] for a in arts)
        out["trellis1"] = np.concatenate([a["trellis1"] for a in arts], 0)
        out["trellis2"] = np.concatenate([a["trellis2"] for a in arts], 0)
        if arts[0].get("tlut") is not None:
            out["tlut"] = arts[0]["tlut"]
    elif kind == "vq":
        assert all(a["meta"]["bits"] == m0["bits"]
                   and a["meta"]["vec"] == m0["vec"] for a in arts)
        if "lut" in arts[0]:
            for a in arts[1:]:
                assert np.allclose(a["lut"], arts[0]["lut"]), \
                    "VQ merge needs identical codebooks"
            out["lut"] = arts[0]["lut"]
        out["qweight"] = np.concatenate([a["qweight"] for a in arts], axis=0)
    else:
        # output-split 'comb' merging would interleave the two bitrate
        # segments of each artifact — the reference's CombLinearTCQ has no
        # merge_infos either (only the input-split CombtLinearTCQ does,
        # comb_linear.py:291-320)
        raise ValueError(f"merge not supported for scheme {kind!r}")
    return out


# ---------------------------------------------------------------------------
# dummy artifacts (reference --dummy / get_dummy_quant_results)
# ---------------------------------------------------------------------------

def dummy_artifact(qstr: str, shape, seed: int = 0) -> dict:
    """Shape-only artifact for --dummy latency mode; packed bits are
    generated on-device in _params_from_artifact (see __device_dummy__)."""
    m, n = shape
    spec = parse_quantizer_str(qstr)
    rng = np.random.default_rng(seed)
    art = {"SU": (rng.standard_normal(n) > 0).astype(np.float32) * 2 - 1,
           "Wscale": np.full((m,), 0.02, np.float32),
           "__device_dummy__": seed}
    if spec.family == "tcq":
        KV = spec.KV[0]
        art["meta"] = {"kind": "tcq", "quantizer_str": qstr, "KV": KV,
                       "tlut_bits": tlut_bits_for_kv(KV),
                       "in_features": n, "out_features": m}
    elif spec.family == "tcomb":
        KV1, KV2 = spec.KV
        art["meta"] = {"kind": "tcomb", "quantizer_str": qstr,
                       "KV1": KV1, "KV2": KV2,
                       "tlut_bits": tlut_bits_for_kv(max(KV1, KV2)),
                       "in_part": (n // 2, n // 2),
                       "in_features": n, "out_features": m}
    elif spec.family in ("tcq1", "tcq1x2"):
        art["meta"] = {"kind": "tcq1", "quantizer_str": qstr,
                       "KV": spec.KV[0],
                       "decode_mode": "1mad" if spec.family == "tcq1"
                       else "2mad",
                       "in_features": n, "out_features": m}
    elif spec.family in ("tcq2", "tcq2s"):
        art["meta"] = {"kind": "tcq2", "quantizer_str": qstr,
                       "KV": spec.KV[0],
                       "decode_mode": ("sum2" if spec.family == "tcq2s"
                                       else "dualmad"),
                       "in_features": n, "out_features": m}
    elif spec.family in ("ldlq", "sq", "vq2"):
        bits, vec = spec.bits, spec.vec
        art["meta"] = {"kind": "vq", "quantizer_str": qstr, "bits": bits,
                       "vec": vec, "in_features": n, "out_features": m}
    else:
        raise ValueError(spec.family)
    return art


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------

def _get_artifact(cfg, model_key, layer, key, qstr, save_dir, seed,
                  dense_w=None, dummy=False, rot_blocks=1, H=None,
                  in_perm_blocks=0):
    """in_perm_blocks > 0 (row-parallel tcomb): quantize against the
    block-permuted W[:, π] (π = original blocks [0,2,...,1,3,...] of
    width n/in_perm_blocks) so each tensor-parallel shard's contiguous
    input slice holds one KV1 and one KV2 piece; SU and H permuted to
    match.  The runtime applies the same permutation to the activation
    (models/llama._block_perm_in)."""
    if dummy:
        import zlib
        # stable across processes (Python's str hash is per-process
        # salted, which broke multi-host dummy-weight agreement)
        dseed = zlib.crc32(f"{layer}_{key}".encode()) % (1 << 31)
        art = dummy_artifact(qstr, proj_shape(cfg, key), seed=dseed)
        # dummy mode must still share SU within each rotation group so
        # merged projections remain constructible
        art["SU"] = su_for(cfg, layer, key, seed)
        art["meta"]["rot_blocks"] = rot_blocks
        art["meta"]["in_perm_blocks"] = in_perm_blocks
        return art
    qdir = qstr if rot_blocks == 1 else f"{qstr}__rb{rot_blocks}"
    if in_perm_blocks:
        qdir += f"__perm{in_perm_blocks}"
        n_full = proj_shape(cfg, key)[1]
        pb = in_perm_blocks
        pi = (np.arange(n_full).reshape(pb // 2, 2, n_full // pb)
              .transpose(1, 0, 2).reshape(-1))
        if dense_w is not None:
            dense_w = np.asarray(dense_w)[:, pi]
        if H is not None:
            H = np.asarray(H)[pi][:, pi]
    path = artifact_path(save_dir, model_key, seed, qdir, layer, key)
    if os.path.exists(path):
        art = load_artifact(path)
        # rotation version check: the artifact was quantized against
        # kron(get_had_factors(n)) — if the current factorization differs
        # (the factor-order choice changed between rounds), decoding would
        # silently use a mismatched activation rotation.  Requantize if we
        # can, otherwise fail loudly.
        from qpalette_tpu.ops.hadamard import get_had_factors
        n_in = art["meta"]["in_features"] // rot_blocks
        want = list(get_had_factors(n_in))
        have = art["meta"].get("had_factors")
        if have is None or list(have) == want:
            if have is None and art["meta"].get("rot_info") == "skip_r":
                import warnings
                warnings.warn(
                    f"{path}: artifact predates rotation version stamps; "
                    f"assuming current factorization {want}")
            return art
        if dense_w is None:
            raise RuntimeError(
                f"{path}: cached artifact used Hadamard factors {have} "
                f"but the current build rotates with {want}; re-quantize "
                f"(no dense weights available to do it automatically)")
        os.remove(path)
    else:
        art = None
    assert dense_w is not None, (
        f"artifact missing and no dense weights to quantize: {path}")
    su = su_for(cfg, layer, key, seed)
    if in_perm_blocks:
        su = su[pi]
    art = quantize_linear(dense_w, qstr, SU=su, H=H, seed=seed,
                          rot_blocks=rot_blocks)
    art["meta"]["in_perm_blocks"] = in_perm_blocks
    save_artifact(art, path)
    return art


def build_quantized_model(cfg: LlamaConfig, qdict, merge_info=None,
                          model_key: str = "model",
                          save_dir: str = "quant_results", seed: int = 0,
                          dense_params: Optional[dict] = None,
                          dummy: bool = False, impl: str = "xla",
                          num_layers: Optional[int] = None,
                          row_parallel_tp: int = 1,
                          lm_head_bits: int = 16,
                          hess: Optional[dict] = None):
    """Assemble (ModelSpec, params) for a quantized Llama.

    qdict: quantizer_str, or dict {f"{i}_{key}": qstr | (qstr, simt)}.
    hess: optional {f"{i}_{qkv|o|up|down}": H} calibration Hessians
    (collect_hessians.py output) consumed by `_hess_` quantizers.
    merge_info: per-layer list like ["merge_qkv", "merge_ug"] or None.
    dense_params: optional dict with dense model params (for
    quantize-on-demand and for embeddings/norms/lm_head).
    row_parallel_tp > 1: quantize o_proj/down_proj against block-diagonal
    input rotations (rot_blocks=tp) for the shard_map tensor-parallel path
    (parallel/tp.py, the reference's `rcp` semantics); requires no merges.
    """
    nl = num_layers if num_layers is not None else cfg.num_layers
    dtype = cfg.dtype

    def qstr_for(i, key):
        """Resolve (quantizer_str, impl) for one projection.

        qdict tuple values carry the solver's per-layer kernel choice
        (reference simt semantics, measure_latency_merge_simt.py:60-105):
        "0"/False = the session default impl; "1"/True = the alternate
        kernel class (xla dequant+matmul when the default is the
        decode-GEMV kernel, and vice versa); an explicit impl name
        ("pallas"|"xla") is used verbatim — what the latency solver emits
        with use_impl_choice.  _spec_from_meta then records the path the
        kind actually takes (resolve_impl)."""
        if isinstance(qdict, str):
            return qdict, impl
        v = qdict[f"{i}_{key}"]
        if isinstance(v, (tuple, list)):
            qs, simt = v
            if simt in ("pallas", "xla"):
                return qs, simt
            if simt in ("1", 1, True, "True"):
                return qs, ("xla" if impl == "pallas" else "pallas")
            return qs, impl
        return v, impl

    layers_params = []
    layer_specs = []
    tlut_bits_used = set()

    for i in range(nl):
        mi = merge_info[i] if merge_info is not None else []
        merge_attn = None
        for mm in ("qkv", "qk", "kv", "qv"):
            if f"merge_{mm}" in mi:
                merge_attn = mm
        merge_ug = "merge_ug" in mi

        # row_parallel_tp only block-rotates o/down (never merged); merged
        # qkv/ug are column-parallel and shard via tile permutation
        # (parallel/tp.shard_interleave_merged)
        arts = {}
        impls = {}
        perms = {}
        for key in LAYER_KEYS:
            qs, impl_k = qstr_for(i, key)
            impls[key] = impl_k
            rb, pb = 1, 0
            if key in ("self_attn.o_proj", "mlp.down_proj"):
                rb = row_parallel_tp
                if row_parallel_tp > 1 and qs.startswith("tcomb"):
                    # input-split tcomb: quantize in the block-permuted
                    # space so each shard's slice holds both KV halves;
                    # rotation blocks halve to the KV-piece width
                    pb = 2 * row_parallel_tp
                    rb = pb
            perms[key] = pb
            from qpalette_tpu.quant.hessian import HESSKEY
            Hk = hess.get(f"{i}_{HESSKEY[key]}") if hess else None
            arts[key] = _get_artifact(
                cfg, model_key, i, key, qs, save_dir, seed,
                dense_w=None if dense_params is None
                else dense_params["layers"][i][key], dummy=dummy,
                rot_blocks=rb, H=Hk, in_perm_blocks=pb)

        def group_impl(*keys):
            """Per-layer impl for a (possibly merged) projection group;
            merged projections must agree on the kernel class."""
            ims = {impls[k] for k in keys}
            assert len(ims) == 1, \
                f"merged projections need one impl, got {ims} for {keys}"
            return ims.pop()

        q, k, v, o = (arts["self_attn.q_proj"], arts["self_attn.k_proj"],
                      arts["self_attn.v_proj"], arts["self_attn.o_proj"])
        gate, up, down = (arts["mlp.gate_proj"], arts["mlp.up_proj"],
                          arts["mlp.down_proj"])

        lp = {"su_qkv": jnp.asarray(q["SU"], dtype),
              "su_o": jnp.asarray(o["SU"], dtype),
              "su_ug": jnp.asarray(up["SU"], dtype),
              "su_dp": jnp.asarray(down["SU"], dtype)}

        KQ, KK, KV_, KO = ("self_attn.q_proj", "self_attn.k_proj",
                           "self_attn.v_proj", "self_attn.o_proj")
        KU, KG, KD = "mlp.up_proj", "mlp.gate_proj", "mlp.down_proj"
        attn_projs = []
        if merge_attn == "qkv":
            m = merge_artifacts([q, k, v])
            im = group_impl(KQ, KK, KV_)
            attn_projs.append(("qkv", _spec_from_meta(m["meta"], im)))
            lp["qkv"] = _params_from_artifact(m, dtype)
        elif merge_attn == "qk":
            m = merge_artifacts([q, k])
            im = group_impl(KQ, KK)
            attn_projs += [("qk", _spec_from_meta(m["meta"], im)),
                           ("v", _spec_from_meta(v["meta"], impls[KV_]))]
            lp["qk"] = _params_from_artifact(m, dtype)
            lp["v"] = _params_from_artifact(v, dtype)
        elif merge_attn == "kv":
            m = merge_artifacts([k, v])
            im = group_impl(KK, KV_)
            attn_projs += [("q", _spec_from_meta(q["meta"], impls[KQ])),
                           ("kv", _spec_from_meta(m["meta"], im))]
            lp["q"] = _params_from_artifact(q, dtype)
            lp["kv"] = _params_from_artifact(m, dtype)
        elif merge_attn == "qv":
            m = merge_artifacts([q, v])
            im = group_impl(KQ, KV_)
            attn_projs += [("qv", _spec_from_meta(m["meta"], im)),
                           ("k", _spec_from_meta(k["meta"], impls[KK]))]
            lp["qv"] = _params_from_artifact(m, dtype)
            lp["k"] = _params_from_artifact(k, dtype)
        else:
            for nm, a, kk in (("q", q, KQ), ("k", k, KK), ("v", v, KV_)):
                attn_projs.append((nm, _spec_from_meta(a["meta"],
                                                       impls[kk])))
                lp[nm] = _params_from_artifact(a, dtype)
        attn_projs.append(("o", _spec_from_meta(o["meta"], impls[KO])))
        lp["o"] = _params_from_artifact(o, dtype)

        if merge_ug:
            m = merge_artifacts([up, gate])
            im = group_impl(KU, KG)
            mlp_projs = (("ug", _spec_from_meta(m["meta"], im)),
                         ("down", _spec_from_meta(down["meta"],
                                                  impls[KD])))
            lp["ug"] = _params_from_artifact(m, dtype)
        else:
            mlp_projs = (("up", _spec_from_meta(up["meta"], impls[KU])),
                         ("gate", _spec_from_meta(gate["meta"],
                                                  impls[KG])),
                         ("down", _spec_from_meta(down["meta"],
                                                  impls[KD])))
            lp["up"] = _params_from_artifact(up, dtype)
            lp["gate"] = _params_from_artifact(gate, dtype)
        lp["down"] = _params_from_artifact(down, dtype)

        for a in arts.values():
            if a["meta"]["kind"] in ("tcq", "tcomb", "comb"):
                tlut_bits_used.add(a["meta"]["tlut_bits"])

        if dense_params is not None:
            lp["ln_attn"] = jnp.asarray(dense_params["layers"][i]["ln_attn"],
                                        dtype)
            lp["ln_mlp"] = jnp.asarray(dense_params["layers"][i]["ln_mlp"],
                                       dtype)
        else:
            lp["ln_attn"] = jnp.ones((cfg.hidden_size,), dtype)
            lp["ln_mlp"] = jnp.ones((cfg.hidden_size,), dtype)

        layers_params.append(lp)
        rb_o = perms[KO] or row_parallel_tp
        rb_d = perms[KD] or row_parallel_tp
        layer_specs.append((AttnSpec(merge_attn, tuple(attn_projs),
                                     rot_blocks_o=rb_o,
                                     in_perm_o=perms[KO]),
                            MLPSpec(merge_ug, tuple(mlp_projs),
                                    rot_blocks_down=rb_d,
                                    in_perm_down=perms[KD])))

    cfg_nl = cfg if nl == cfg.num_layers else \
        LlamaConfig(**{**cfg.__dict__, "num_layers": nl})
    spec = ModelSpec(cfg_nl, tuple(layer_specs))

    luts = {f"tcq{tb}": jnp.asarray(trellis_lut(tb), dtype)
            for tb in sorted(tlut_bits_used)}
    params = {"layers": layers_params, "luts": luts}
    if dense_params is not None:
        params["embed"] = jnp.asarray(dense_params["embed"], dtype)
        params["lm_head"] = jnp.asarray(dense_params["lm_head"], dtype)
        params["ln_f"] = jnp.asarray(dense_params["ln_f"], dtype)
    else:
        # random embeddings drawn on the device from the seed (a host draw
        # of two 128k x 4096 tables would dominate set-up at the 8B widths)
        scale = 0.02
        ke, kl = jax.random.split(jax.random.PRNGKey(seed))
        shp = (cfg.vocab_size, cfg.hidden_size)
        params["embed"] = (jax.random.normal(ke, shp, jnp.float32)
                           * scale).astype(dtype)
        params["lm_head"] = (params["embed"] if cfg.tie_embeddings else
                             (jax.random.normal(kl, shp, jnp.float32)
                              * scale).astype(dtype))
        params["ln_f"] = jnp.ones((cfg.hidden_size,), dtype)
    lm_spec = None
    if lm_head_bits == 4:
        # 4-bit trellis (tcq2s_8) lm_head: the single largest per-token
        # stream (525 MB as int8) halves again to ~268 MB.  Vocab pads
        # to 2^17 so the decode-GEMV kernel gets power-of-two m-blocks;
        # quantized with the same left-only incoherence rotation as the
        # decoder layers (proxy err 0.0071/weight, assets/quant_err.json
        # tcq2s_8).  The reference keeps lm_head fp16.
        h = cfg.hidden_size
        # next 4096-multiple (m/16 divisible by 256): 128256 -> 131072
        VP = -(-cfg.vocab_size // 4096) * 4096
        su = np.asarray((np.random.default_rng(seed * 7 + 99)
                         .standard_normal(h) > 0) * 2.0 - 1.0, np.float32)
        qstr_lm = "tcq2s_8_none_0.9"
        if dense_params is None:
            art = dummy_artifact(qstr_lm, (VP, h), seed=seed * 11 + 5)
            art["SU"] = su
        else:
            w = np.asarray(params.pop("lm_head"), np.float32)
            w = np.pad(w, ((0, VP - w.shape[0]), (0, 0)))
            path = artifact_path(save_dir, model_key, seed, qstr_lm,
                                 999, "lm_head")
            art = None
            if os.path.exists(path):
                art = load_artifact(path)
                # same rotation version check as _get_artifact: a cached
                # lm_head quantized against different Hadamard factors
                # would silently decode against a mismatched rotation
                from qpalette_tpu.ops.hadamard import get_had_factors
                if list(art["meta"].get("had_factors", [])) != \
                        list(get_had_factors(h)):
                    os.remove(path)
                    art = None
            if art is None:
                art = quantize_linear(w, qstr_lm, SU=su, seed=seed)
                save_artifact(art, path)
        params.pop("lm_head", None)
        lm_spec = _spec_from_meta(art["meta"], impl)
        params["lm_head_q4"] = _params_from_artifact(art, dtype)
        params["lm_head_su"] = jnp.asarray(su, jnp.float32)
    elif lm_head_bits == 8:
        # ROTATED per-row symmetric int8 lm_head, stored transposed
        # (k, vocab).  The incoherence rotation (same left-only
        # SU+Hadamard as the quantized layers) tightens the per-row weight
        # absmax.  The reference keeps lm_head fp16; int8 halves the
        # largest single per-token stream.
        from qpalette_tpu.ops.hadamard import hadamard_transform
        h = cfg.hidden_size
        su = jnp.asarray((np.random.default_rng(seed * 7 + 99)
                          .standard_normal(h) > 0) * 2.0 - 1.0, jnp.float32)
        w = params.pop("lm_head").astype(jnp.float32)
        w = hadamard_transform(w * su[None, :])
        s = jnp.max(jnp.abs(w), axis=1, keepdims=True) / 127.0 + 1e-12
        q = jnp.round(w / s).astype(jnp.int8).T
        sT = s.astype(jnp.float32).T  # (1, vocab)
        # pad vocab to a 2048 multiple (128256 = 2^8·3·167); model
        # forward slices logits back to vocab_size
        mpad = (-q.shape[1]) % 2048
        if mpad:
            q = jnp.pad(q, ((0, 0), (0, mpad)))
            sT = jnp.pad(sT, ((0, 0), (0, mpad)), constant_values=1.0)
        params["lm_head_q"] = q
        params["lm_head_s"] = sT
        params["lm_head_su"] = su
    if lm_spec is not None:
        spec = ModelSpec(spec.config, spec.layers, spec.tp_axis,
                         lm_head_spec=lm_spec)
    return spec, params


def sum2mix_qdict(num_layers: int) -> dict:
    """The hand 3.27-bit arithmetic-trellis mix: tcq2s_6 (3.0 b) on
    q/k/v/o/up/gate, tcq2s_8 (4.0 b) on down.  Merge-compatible within the
    fused qkv and gate-up groups (same KV and mode)."""
    return {f"{i}_{key}": ("tcq2s_8_none_0.9" if key == "mlp.down_proj"
                           else "tcq2s_6_none_0.9")
            for i in range(num_layers) for key in LAYER_KEYS}


def with_impl(spec: ModelSpec, impl: str) -> ModelSpec:
    """The same model (same params) with every quantized projection and
    the quantized lm_head re-resolved for `impl`."""
    import dataclasses

    def relink(ls):
        if ls.kind in ("dense", "dense_rot"):
            return ls
        return dataclasses.replace(ls, impl=resolve_impl(ls.kind, impl))

    layers = tuple(
        (dataclasses.replace(a, projs=tuple((n, relink(ls))
                                            for n, ls in a.projs)),
         dataclasses.replace(m, projs=tuple((n, relink(ls))
                                            for n, ls in m.projs)))
        for a, m in spec.layers)
    lm = spec.lm_head_spec
    return dataclasses.replace(spec, layers=layers,
                               lm_head_spec=None if lm is None
                               else relink(lm))


def random_dense_params(cfg: LlamaConfig, seed: int = 0,
                        scale: float = 0.02) -> dict:
    """Random dense Llama params (for tests and dummy quantization)."""
    rng = np.random.default_rng(seed)

    def w(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    layers = []
    for _ in range(cfg.num_layers):
        lp = {k: w(proj_shape(cfg, k)) for k in LAYER_KEYS}
        lp["ln_attn"] = np.ones((cfg.hidden_size,), np.float32)
        lp["ln_mlp"] = np.ones((cfg.hidden_size,), np.float32)
        layers.append(lp)
    emb = w((cfg.vocab_size, cfg.hidden_size))
    return {"layers": layers, "embed": emb,
            "lm_head": emb if cfg.tie_embeddings
            else w((cfg.vocab_size, cfg.hidden_size)),
            "ln_f": np.ones((cfg.hidden_size,), np.float32)}


def build_dense_model(cfg: LlamaConfig, dense_params: dict):
    """Unquantized bf16 baseline model (reference fp16 baseline)."""
    dtype = cfg.dtype
    layer_specs = []
    layers_params = []
    for i in range(cfg.num_layers):
        dp = dense_params["layers"][i]
        lp = {}
        projs = []
        for nm, key in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                        ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj")):
            m, n = proj_shape(cfg, key)
            projs.append((nm, LinearSpec("dense", n, m)))
            lp[nm] = {"w": jnp.asarray(dp[key], dtype)}
        aspec = AttnSpec(None, tuple(projs))
        mprojs = []
        for nm, key in (("up", "mlp.up_proj"), ("gate", "mlp.gate_proj"),
                        ("down", "mlp.down_proj")):
            m, n = proj_shape(cfg, key)
            mprojs.append((nm, LinearSpec("dense", n, m)))
            lp[nm] = {"w": jnp.asarray(dp[key], dtype)}
        mspec = MLPSpec(False, tuple(mprojs))
        # dense path needs identity rotations
        lp["su_qkv"] = jnp.ones((cfg.hidden_size,), dtype)
        lp["su_o"] = jnp.ones((cfg.hidden_size,), dtype)
        lp["su_ug"] = jnp.ones((cfg.hidden_size,), dtype)
        lp["su_dp"] = jnp.ones((cfg.intermediate_size,), dtype)
        lp["ln_attn"] = jnp.asarray(dp["ln_attn"], dtype)
        lp["ln_mlp"] = jnp.asarray(dp["ln_mlp"], dtype)
        layers_params.append(lp)
        layer_specs.append((aspec, mspec))
    spec = ModelSpec(cfg, tuple(layer_specs))
    params = {"layers": layers_params,
              "luts": {},
              "embed": jnp.asarray(dense_params["embed"], dtype),
              "lm_head": jnp.asarray(dense_params["lm_head"], dtype),
              "ln_f": jnp.asarray(dense_params["ln_f"], dtype)}
    return spec, params
