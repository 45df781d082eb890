"""Incoherence processing + quantizer_str DSL + per-layer artifacts.

Reference behavior:
  - incoherent transform (left-only): lib/quantizer/tcq_quant.py:108-143 and
    lib/quantizer/vq_quant.py:101-131 — W ← Ĥᵀ-rotate(W ⊙ SU), per-row
    Wscale = RMS / (codebook RMS × scale_override); Hessian rotated to match.
  - quantizer_str DSL: quantize_layer.py:28-97
      tcq_{KV}_{hess|none}_{scale}       trellis-coded, KV/2 bits/weight
      tcomb_{KV1}_{KV2}_{r}_{hess}_{s}   input-split fractional TCQ
      comb_{KV1}_{KV2}_{r}_{hess}_{s}    output-split fractional TCQ
      ldlq_{vec}_{bits}_{hess}_{scale}   VQ/SQ via LDLQ
      sq_{bits}_{hess}_{scale}           scalar VQ via kmeans+ALS
      vq2_{bits}_{hess}_{scale}          2-dim VQ via kmeans+ALS
  - artifact schema + save: lib/linear/incoherent_linear.py:467-484
  - skip-if-exists resume: quantize_layer.py:139-147

Artifacts are .npz files (no torch): arrays + a small JSON metadata blob.

Rotation convention (differs from reference but self-consistent; see
ops/hadamard.py): quantize-side uses the *forward* transform on W rows
(Wr = (W ⊙ SU) @ Ĥ) and the runtime applies the *transpose* transform to
activations (z = (x ⊙ SU) @ Ĥᵀ), so Wq z = W x exactly.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from qpalette_tpu.ops.hadamard import hadamard_transform, random_signs
from qpalette_tpu.ops.codebooks import (trellis_lut, vq_lut, lut_rms,
                                        tlut_bits_for_kv, trellis_tlut)
from qpalette_tpu.quant import quantizers


@dataclass(frozen=True)
class QuantizerSpec:
    """Parsed quantizer_str."""
    qstr: str
    family: str              # tcq | tcomb | comb | ldlq | sq | vq2
    use_hess: bool
    scale_override: float
    KV: tuple | None = None   # tcq: (KV,), comb/tcomb: (KV1, KV2)
    ratio: float | None = None
    bits: int | None = None
    vec: int | None = None

    @property
    def avg_bits(self) -> float:
        """Bits per weight, excluding LUT overhead (cf. solver QDICT)."""
        if self.family in ("tcq1", "tcq1x2"):
            return float(self.KV[0])
        if self.family in ("tcq", "tcq2", "tcq2s"):
            return self.KV[0] / 2
        if self.family in ("tcomb", "comb"):
            return (self.KV[0] + self.KV[1]) / 4
        return self.bits / self.vec


def parse_quantizer_str(qstr: str) -> QuantizerSpec:
    parts = qstr.split("_")
    fam = parts[0]
    if fam == "tcq":
        _, kv, hess, scale = parts
        return QuantizerSpec(qstr, "tcq", hess == "hess", float(scale),
                             KV=(int(kv),))
    if fam in ("tcq1", "tcq1x2", "tcq2", "tcq2s"):
        # arithmetic-decode trellis: tcq1 = 1mad (V=1), tcq1x2 = 2mad (V=1),
        # tcq2 = dualmad (V=2, KV/2 bits/weight — fractional bitrates
        # without comb splits), tcq2s = sum2 (V=2, one scramble per weight
        # pair — the cheapest decode of the palette)
        _, kv, hess, scale = parts
        return QuantizerSpec(qstr, fam, hess == "hess", float(scale),
                             KV=(int(kv),))
    if fam in ("tcomb", "comb"):
        _, kv1, kv2, ratio, hess, scale = parts
        return QuantizerSpec(qstr, fam, hess == "hess", float(scale),
                             KV=(int(kv1), int(kv2)), ratio=float(ratio))
    if fam == "ldlq":
        _, vec, bits, hess, scale = parts
        return QuantizerSpec(qstr, "ldlq", hess == "hess", float(scale),
                             bits=int(bits), vec=int(vec))
    if fam == "sq":
        _, bits, hess, scale = parts
        return QuantizerSpec(qstr, "sq", hess == "hess", float(scale),
                             bits=int(bits), vec=1)
    if fam == "vq2":
        _, bits, hess, scale = parts
        return QuantizerSpec(qstr, "vq2", hess == "hess", float(scale),
                             bits=int(bits), vec=2)
    if fam == "rotfp16":
        # rotated dense baseline (reference model/rotated_llama.py:306-391
        # QuaRot-style fp16 model with online Hadamard)
        return QuantizerSpec(qstr, "rotfp16", False, 1.0, bits=16, vec=1)
    raise ValueError(f"unknown quantizer_str {qstr!r}")


def _rotate_weight(W: jax.Array, SU: jax.Array,
                   rot_blocks: int = 1) -> jax.Array:
    return hadamard_transform(W.astype(jnp.float32) * SU[None, :],
                              blocks=rot_blocks)


def rotate_hessian(H: jax.Array, SU: jax.Array,
                   rot_blocks: int = 1) -> jax.Array:
    """HRr = Ĥᵀ S H S Ĥ (reference tcq_quant.py:133-135)."""
    B = hadamard_transform(H.astype(jnp.float32) * SU[None, :],
                           blocks=rot_blocks)
    return hadamard_transform(B.T * SU[None, :], blocks=rot_blocks).T


def quantize_linear(W, quantizer_str: str, SU=None, H=None,
                    seed: int = 0, rot_blocks: int = 1) -> dict:
    """Quantize one linear weight (out, in) -> artifact dict.

    Mirrors quantize_layer.quantize_linear (quantize_layer.py:28-97),
    left-only incoherence (rot_info='skip_r', the only mode the reference
    exercises — quantize_layer.py:126-130).

    rot_blocks > 1 quantizes against a block-diagonal input rotation
    (I_b ⊗ Ĥ_{n/b}) — required for row-parallel (input-sharded) layers so
    each tensor-parallel shard rotates locally (reference `rcp` semantics,
    bitshift.py:374-388).
    """
    spec = parse_quantizer_str(quantizer_str)
    W = jnp.asarray(W)
    m, n = W.shape
    if SU is None:
        SU = random_signs(n, jax.random.PRNGKey(seed))
    SU = jnp.asarray(SU, jnp.float32)

    Wr = _rotate_weight(W, SU, rot_blocks)
    if spec.family in ("tcq", "tcomb", "comb"):
        cb_rms = lut_rms(trellis_lut(tlut_bits_for_kv(max(spec.KV))))
    elif spec.family in ("tcq1", "tcq1x2", "tcq2", "tcq2s"):
        from qpalette_tpu.ops.codebooks import trellis_lut_arith
        cb_rms = lut_rms(trellis_lut_arith(
            {"tcq1": "1mad", "tcq1x2": "2mad",
             "tcq2": "dualmad", "tcq2s": "sum2"}[spec.family]))
    else:
        cb_rms = 1.0
    row_rms = jnp.sqrt(jnp.mean(Wr.astype(jnp.float64) ** 2, axis=1))
    # all-zero rows (e.g. lm_head vocab padding) would give Wscale=0 and
    # Wr/Wscale = 0/0 = NaN, poisoning artifact meta err/kurtosis — clamp
    # to a benign scale (the quantizer then codes exact zeros for the row)
    row_rms = jnp.maximum(row_rms, 1e-8)
    Wscale = (row_rms / (cb_rms * spec.scale_override)).astype(jnp.float32)
    Wr = Wr / Wscale[:, None]

    HRr = None
    if spec.use_hess and H is not None:
        HRr = rotate_hessian(jnp.asarray(H), SU, rot_blocks)

    if spec.family == "tcq":
        linear, hatWr = quantizers.quantize_mat_tcq(
            Wr, HRr, spec.KV[0], spec.use_hess and HRr is not None)
    elif spec.family in ("tcq1", "tcq1x2"):
        linear, hatWr = quantizers.quantize_mat_tcq1(
            Wr, HRr, spec.KV[0],
            mode="1mad" if spec.family == "tcq1" else "2mad",
            use_hess=spec.use_hess and HRr is not None)
    elif spec.family in ("tcq2", "tcq2s"):
        linear, hatWr = quantizers.quantize_mat_tcq2(
            Wr, HRr, spec.KV[0],
            use_hess=spec.use_hess and HRr is not None,
            mode="sum2" if spec.family == "tcq2s" else "dualmad")
    elif spec.family == "tcomb":
        assert spec.ratio == 0.5, "only ratio=0.5 supported (as in reference)"
        linear, hatWr = quantizers.quantize_mat_combt(
            Wr, HRr, spec.KV[0], spec.KV[1], spec.use_hess and HRr is not None)
    elif spec.family == "comb":
        m0 = int(m * spec.ratio)
        linear, hatWr = quantizers.quantize_mat_comb(
            Wr, HRr, spec.KV[0], spec.KV[1], (m0, m - m0),
            spec.use_hess and HRr is not None)
    elif spec.family in ("ldlq",):
        linear, hatWr = quantizers.quantize_mat_vq(
            Wr, HRr, spec.bits, spec.vec, spec.use_hess and HRr is not None)
    elif spec.family == "rotfp16":
        linear = {"kind": "dense_rot",
                  "w": np.asarray(Wr, np.float32),
                  "in_features": n, "out_features": m}
        hatWr = Wr
    elif spec.family in ("sq", "vq2"):
        # kmeans+ALS family; LDLQ machinery with data-built codebook would be
        # the full ALS — round-1 uses the shared LDLQ path with the standard
        # Gaussian codebook (hess-weighted ALS refinement in quant/als.py).
        from qpalette_tpu.quant.als import quantize_mat_vq_als
        linear, hatWr = quantize_mat_vq_als(
            Wr, HRr, spec.bits, spec.vec, use_hess=spec.use_hess and HRr is not None)
    else:
        raise ValueError(spec.family)

    scaled_W = Wr * Wscale[:, None]
    scaled_hat = hatWr * Wscale[:, None]
    orig_err = float(jnp.mean((scaled_W - scaled_hat) ** 2))
    rel_err = float(orig_err / jnp.mean(scaled_W ** 2))

    # incoherence diagnostics (reference calc_kurtosis/skewness,
    # incoherent_linear.py:561-569)
    Wn = Wr / jnp.maximum(
        jnp.sqrt(jnp.mean(Wr ** 2, axis=1, keepdims=True)), 1e-12)
    kurt = float(jnp.mean(jnp.mean(Wn ** 4, axis=1) - 3.0))
    skew = float(jnp.mean(jnp.mean(Wn ** 3, axis=1)))

    from qpalette_tpu.ops.hadamard import get_had_factors
    art = {
        "meta": {
            "quantizer_str": quantizer_str,
            "kind": linear.pop("kind"),
            "in_features": n,
            "out_features": m,
            "rot_info": "skip_r",
            "rot_blocks": rot_blocks,
            # rotation version stamp: the Kronecker factorization used for
            # the incoherence rotation.  The runtime re-derives the same
            # rotation from (n, rot_blocks); if get_had_factors ever
            # changes its factor choice (as it did between rounds 2 and 3),
            # old cached artifacts would silently decode against a
            # mismatched activation rotation — loader._get_artifact checks
            # this stamp and refuses stale caches.
            "had_factors": list(get_had_factors(n // rot_blocks)),
            "err": rel_err,
            "orig_err": orig_err,
            "kurtosis": kurt,
            "skewness": skew,
            **{k: v for k, v in linear.items()
               if not isinstance(v, np.ndarray)},
        },
        "SU": np.asarray(SU, np.float32),
        "Wscale": np.asarray(Wscale, np.float32),
    }
    for k, v in linear.items():
        if isinstance(v, np.ndarray):
            art[k] = v
    # attach the LUTs the runtime needs
    if art["meta"]["kind"] in ("tcq", "tcomb", "comb"):
        art["tlut"] = np.asarray(trellis_tlut(art["meta"]["tlut_bits"]))
    elif art["meta"]["kind"] == "vq":
        if "lut" not in art:
            art["lut"] = np.asarray(vq_lut(spec.bits, spec.vec))
    return art


# ---------------------------------------------------------------------------
# artifact IO (resume-at-layer-granularity, reference quantize_layer.py:139-147)
# ---------------------------------------------------------------------------

def artifact_path(save_dir: str, model_key: str, seed: int,
                  quantizer_str: str, layer_idx: int, layer_key: str) -> str:
    return os.path.join(save_dir, model_key, f"left_only_seed{seed}_cache",
                        quantizer_str, f"{layer_idx}_{layer_key}.npz")


def save_artifact(art: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {k: v for k, v in art.items() if k != "meta"}
    np.savez(path, __meta__=json.dumps(art["meta"]), **arrays)


def load_artifact(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        art = {k: z[k] for k in z.files if k != "__meta__"}
        art["meta"] = json.loads(str(z["__meta__"]))
    return art
