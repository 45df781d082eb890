"""Calibration: input-Hessian collection + per-layer sensitivity coeffs.

Reference behavior:
  - lib/utils/data_utils.py:28-50 (register_input_H_hook): accumulate
    H = Σ xᵀx (flat upper-tri storage) per projection-input group, keyed
    {layer}_{qkv|o|up|down} (quantize_layer.py HESSKEY :10-18).
  - calibration samplers: RedPajama/RefinedWeb (:197-281); any token stream
    works here.
  - assets/{model}_err_coeffs.pt: per-linear sensitivity weights for the
    MSQ objective (consumed solve_mem_const.py:137-139).  The reference
    ships these precomputed; we derive them from the same calibration pass:
    coeff(layer) = tr(H_group)/n · ||W||_F² / (m·n), i.e. the expected
    output-energy scale of a unit relative weight perturbation.

No hooks: the functional forward is re-run with a capture list (one jit
per layer-group batch), accumulating H in f32 on device.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp

from qpalette_tpu.models import llama
from qpalette_tpu.models.llama import rms_norm

HESS_GROUPS = ["qkv", "o", "up", "down"]
HESSKEY = {  # reference quantize_layer.py:10-18
    "self_attn.q_proj": "qkv", "self_attn.k_proj": "qkv",
    "self_attn.v_proj": "qkv", "self_attn.o_proj": "o",
    "mlp.up_proj": "up", "mlp.gate_proj": "up", "mlp.down_proj": "down",
}


def _gram(z):
    """zᵀz in full f32 (the GPU's default f32 matmul is TF32)."""
    return jnp.matmul(z.T, z, precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("spec",))
def _collect_step(spec, params, tokens, Hs):
    """Accumulate Σ zᵀz for the qkv / o / up / down group inputs."""
    cfg = spec.config
    B, S = tokens.shape
    x = jnp.take(params["embed"], tokens, axis=0).astype(cfg.dtype)
    pos = jnp.arange(S)[None, :]
    cos, sin = llama.rope_tables(pos, cfg.head_dim, cfg.rope_theta)

    new_Hs = []
    for li, (aspec, mspec) in enumerate(spec.layers):
        lp = params["layers"][li]
        h = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
        N = h.shape[-1]
        a, _ = llama.attn_forward(aspec, cfg, lp, h, cos, sin, offset=0,
                                  luts=params.get("luts", {}))
        x = x + a
        h2 = rms_norm(x, lp["ln_mlp"], cfg.rms_eps)
        # group inputs: qkv <- h ; up <- h2 ; down <- silu(gate)*up ;
        # o <- attention context (recomputed below)
        hq = h.reshape(-1, N).astype(jnp.float32)
        hu = h2.reshape(-1, N).astype(jnp.float32)
        # recompute inner activations for o/down inputs
        o_in, dp_in = _inner_inputs(aspec, mspec, cfg, lp, h, h2, cos,
                                    sin)
        Hq, Ho, Hu, Hd = Hs[li]
        new_Hs.append((
            Hq + _gram(hq),
            Ho + _gram(o_in),
            Hu + _gram(hu),
            Hd + _gram(dp_in),
        ))
        out = llama.mlp_forward(mspec, cfg, lp, h2,
                                luts=params.get("luts", {}))
        x = x + out
    return new_Hs


def _inner_inputs(aspec, mspec, cfg, lp, h, h2, cos, sin):
    """Recompute o-proj and down-proj inputs (pre-rotation)."""
    from qpalette_tpu.models.llama import (_attention, _rotate_in,
                                           apply_rope, qlinear_apply)
    B, S, N = h.shape
    rotated = aspec.projs[0][1].kind != "dense"
    z = (_rotate_in(h.reshape(-1, N), lp["su_qkv"]).reshape(B, S, N)
         if rotated else h)
    outs = {}
    for name, lspec in aspec.projs:
        if name == "o":
            continue
        outs[name] = qlinear_apply(lspec, lp[name],
                                   z.reshape(-1, N)).reshape(B, S, -1)
    hs, kvd = cfg.hidden_size, cfg.kv_out
    if aspec.merge == "qkv":
        qq, kk, vv = jnp.split(outs["qkv"], [hs, hs + kvd], axis=-1)
    elif aspec.merge == "qk":
        qq, kk = jnp.split(outs["qk"], [hs], axis=-1)
        vv = outs["v"]
    elif aspec.merge == "kv":
        kk, vv = jnp.split(outs["kv"], [kvd], axis=-1)
        qq = outs["q"]
    elif aspec.merge == "qv":
        qq, vv = jnp.split(outs["qv"], [hs], axis=-1)
        kk = outs["k"]
    else:
        qq, kk, vv = outs["q"], outs["k"], outs["v"]
    qq = qq.reshape(B, S, cfg.num_heads, cfg.head_dim)
    kk = kk.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    vv = vv.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    qq = apply_rope(qq, cos, sin)
    kk = apply_rope(kk, cos, sin)
    att = _attention(qq, kk, vv, 0, cfg)
    o_in = att.reshape(-1, N).astype(jnp.float32)

    rotated_m = mspec.projs[0][1].kind != "dense"
    zm = (_rotate_in(h2.reshape(-1, N), lp["su_ug"]) if rotated_m
          else h2.reshape(-1, N))
    if mspec.merge_ug:
        y = qlinear_apply(mspec.projs[0][1], lp["ug"], zm)
        upv, gate = y[:, :cfg.intermediate_size], y[:, cfg.intermediate_size:]
    else:
        upv = qlinear_apply(mspec.projs[0][1], lp["up"], zm)
        gate = qlinear_apply(mspec.projs[1][1], lp["gate"], zm)
    dp_in = (jax.nn.silu(gate.astype(jnp.float32))
             * upv.astype(jnp.float32))
    return o_in, dp_in


def collect_hessians(spec, params, token_batches: List[np.ndarray]):
    """Σ zᵀz Hessians per (layer, group).  Returns
    {f"{i}_{group}": H (n, n) float32} (reference flatH schema equivalent)."""
    cfg = spec.config
    n_h = cfg.hidden_size
    n_i = cfg.intermediate_size
    Hs = [(jnp.zeros((n_h, n_h), jnp.float32),
           jnp.zeros((n_h, n_h), jnp.float32),
           jnp.zeros((n_h, n_h), jnp.float32),
           jnp.zeros((n_i, n_i), jnp.float32))
          for _ in range(cfg.num_layers)]
    count = 0
    for batch in token_batches:
        Hs = _collect_step(spec, params, jnp.asarray(batch, jnp.int32), Hs)
        count += batch.shape[0] * batch.shape[1]
    out = {}
    for li, (Hq, Ho, Hu, Hd) in enumerate(Hs):
        out[f"{li}_qkv"] = np.asarray(Hq) / count
        out[f"{li}_o"] = np.asarray(Ho) / count
        out[f"{li}_up"] = np.asarray(Hu) / count
        out[f"{li}_down"] = np.asarray(Hd) / count
    return out


@functools.partial(jax.jit, static_argnames=("spec",))
def _energy_step(spec, params, tokens, acc):
    """Accumulate Σ z² (scalar) per (layer, group) input — the tr(H)/n
    diagonal summary err_coeffs need, WITHOUT materializing the (n, n)
    Hessians (a 14336² f32 per layer ×32 would not fit host RAM for the
    8B synthetic-calibration run)."""
    cfg = spec.config
    B, S = tokens.shape
    x = jnp.take(params["embed"], tokens, axis=0).astype(cfg.dtype)
    pos = jnp.arange(S)[None, :]
    cos, sin = llama.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    new_acc = []
    for li, (aspec, mspec) in enumerate(spec.layers):
        lp = params["layers"][li]
        h = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
        a, _ = llama.attn_forward(aspec, cfg, lp, h, cos, sin, offset=0,
                                  luts=params.get("luts", {}))
        x = x + a
        h2 = rms_norm(x, lp["ln_mlp"], cfg.rms_eps)
        o_in, dp_in = _inner_inputs(aspec, mspec, cfg, lp, h, h2, cos, sin)
        aq, ao, au, ad = acc[li]
        new_acc.append((
            aq + jnp.mean(h.astype(jnp.float32) ** 2),
            ao + jnp.mean(o_in ** 2),
            au + jnp.mean(h2.astype(jnp.float32) ** 2),
            ad + jnp.mean(dp_in ** 2),
        ))
        x = x + llama.mlp_forward(mspec, cfg, lp, h2,
                                  luts=params.get("luts", {}))
    return new_acc


def collect_group_energy(spec, params,
                         token_batches: List[np.ndarray]) -> Dict[str, float]:
    """Mean input energy (= tr(H)/n) per {layer}_{qkv|o|up|down} group."""
    nl = spec.config.num_layers
    acc = [(jnp.float32(0),) * 4 for _ in range(nl)]
    for batch in token_batches:
        acc = _energy_step(spec, params, jnp.asarray(batch, jnp.int32), acc)
    nb = len(token_batches)
    out = {}
    for li, (aq, ao, au, ad) in enumerate(acc):
        out[f"{li}_qkv"] = float(aq) / nb
        out[f"{li}_o"] = float(ao) / nb
        out[f"{li}_up"] = float(au) / nb
        out[f"{li}_down"] = float(ad) / nb
    return out


def err_coeffs_from_energy(energy: Dict[str, float], dense_params: dict,
                           num_layers: int) -> Dict[str, float]:
    """Sensitivity coeff per linear from group input energies + weight
    energies: same formula as err_coeffs_from_hessians (tr(H)/n ·
    mean(W²)), computable from the diagonal summary alone."""
    from qpalette_tpu.msq.memmodel import LAYER_KEYS
    coeffs = {}
    for i in range(num_layers):
        for key in LAYER_KEYS:
            W = np.asarray(dense_params["layers"][i][key])
            coeffs[f"{i}_{key}"] = float(
                energy[f"{i}_{HESSKEY[key]}"]
                * np.mean(W.astype(np.float64) ** 2))
    mean = np.mean(list(coeffs.values()))
    return {k: v / mean for k, v in coeffs.items()}


def err_coeffs_from_hessians(hessians: Dict[str, np.ndarray],
                             dense_params: dict,
                             num_layers: int) -> Dict[str, float]:
    """Sensitivity coeff per linear: mean input energy × weight energy
    (the first-order proxy for loss impact of weight-space MSE)."""
    from qpalette_tpu.msq.memmodel import LAYER_KEYS
    coeffs = {}
    for i in range(num_layers):
        for key in LAYER_KEYS:
            H = hessians[f"{i}_{HESSKEY[key]}"]
            W = np.asarray(dense_params["layers"][i][key])
            coeffs[f"{i}_{key}"] = float(np.trace(H) / H.shape[0]
                                         * np.mean(W.astype(np.float64)**2))
    # normalize to mean 1 for numerical comparability with unit tables
    mean = np.mean(list(coeffs.values()))
    return {k: v / mean for k, v in coeffs.items()}
