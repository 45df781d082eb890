import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qpalette_tpu.models.llama import LlamaConfig, forward, init_kv_caches
from qpalette_tpu.runtime.loader import (build_dense_model,
                                         build_quantized_model,
                                         random_dense_params)
from qpalette_tpu.runtime.decode import decode_step, prefill, generate
from qpalette_tpu.runtime.evaluate import ce_loss

CFG = LlamaConfig.tiny()


@pytest.fixture(scope="module")
def dense_setup():
    dp = random_dense_params(CFG, seed=0)
    spec, params = build_dense_model(CFG, dp)
    return dp, spec, params


def test_dense_forward_shapes(dense_setup):
    _, spec, params = dense_setup
    toks = np.arange(8)[None, :] % CFG.vocab_size
    logits = forward(spec, params, jnp.asarray(toks, jnp.int32))
    assert logits.shape == (1, 8, CFG.vocab_size)
    assert np.isfinite(np.asarray(logits)).all()


def test_quantized_close_to_dense_at_high_bits(dense_setup, tmp_path):
    dp, dspec, dparams = dense_setup
    qspec, qparams = build_quantized_model(
        CFG, "ldlq_1_8_none_1.0", model_key="tiny",
        save_dir=str(tmp_path), dense_params=dp)
    toks = jnp.asarray(np.arange(16)[None, :] % CFG.vocab_size, jnp.int32)
    ld = forward(dspec, dparams, toks)
    lq = forward(qspec, qparams, toks)
    # 8-bit SQ should track the dense model closely at the loss level
    den = float(ce_loss(dspec, dparams, toks))
    qn = float(ce_loss(qspec, qparams, toks))
    assert abs(den - qn) < 0.1, (den, qn)
    rel = float(jnp.mean((ld - lq) ** 2) / jnp.mean(ld ** 2))
    assert rel < 0.05, rel


@pytest.mark.parametrize("qstr,merge", [
    pytest.param("tcq_4_none_0.9", None, marks=pytest.mark.slow),
    pytest.param("tcomb_4_5_0.5_none_0.9", ["merge_qkv", "merge_ug"],
                 marks=pytest.mark.slow),
    ("ldlq_2_4_none_1.0", ["merge_kv"]),
])
def test_quantized_forward_and_merges(dense_setup, tmp_path, qstr, merge):
    dp, dspec, dparams = dense_setup
    merge_info = [merge or []] * CFG.num_layers
    qspec, qparams = build_quantized_model(
        CFG, qstr, merge_info=merge_info, model_key=f"tiny_{qstr[:4]}",
        save_dir=str(tmp_path), dense_params=dp)
    toks = jnp.asarray(np.arange(16)[None, :] % CFG.vocab_size, jnp.int32)
    lq = forward(qspec, qparams, toks)
    assert np.isfinite(np.asarray(lq)).all()
    # 2-bit-ish quantization of random weights is lossy; just require the
    # outputs to correlate with dense
    ld = np.asarray(forward(dspec, dparams, toks)).ravel()
    lqv = np.asarray(lq).ravel()
    corr = np.corrcoef(ld, lqv)[0, 1]
    assert corr > 0.5, corr


@pytest.mark.parametrize("qstr", [
    pytest.param("tcq_4_none_0.9", marks=pytest.mark.slow),
    "tcq1_3_none_0.9",   # the benchmarked scheme — real-artifact merge
    pytest.param("tcq2_6_none_0.9", marks=pytest.mark.slow),
])
def test_merged_equals_unmerged(dense_setup, tmp_path, qstr):
    """Fused QKV/UG projections must produce identical math to unfused,
    built from REAL quantized artifacts (merge_artifacts row-concat,
    reference tcq_linear.py:86-122)."""
    dp, _, _ = dense_setup
    spec_u, par_u = build_quantized_model(
        CFG, qstr, model_key="tiny_mrg", save_dir=str(tmp_path),
        dense_params=dp)
    spec_m, par_m = build_quantized_model(
        CFG, qstr, merge_info=[["merge_qkv", "merge_ug"]] * CFG.num_layers,
        model_key="tiny_mrg", save_dir=str(tmp_path), dense_params=dp)
    toks = jnp.asarray(np.arange(8)[None, :] % CFG.vocab_size, jnp.int32)
    lu = np.asarray(forward(spec_u, par_u, toks))
    lm = np.asarray(forward(spec_m, par_m, toks))
    assert np.allclose(lu, lm, atol=2e-2), np.abs(lu - lm).max()


@pytest.mark.parametrize("offset", [0, 3])
def test_flash_attention_matches_dense(offset):
    """Blockwise (flash) attention == dense-mask attention (SURVEY §5.7:
    the ctx-8192 ppl path must not materialize (B,h,S,T) f32)."""
    from qpalette_tpu.models.llama import _attention, _attention_flash
    cfg = CFG
    B, S, D = 2, 64, cfg.head_dim
    T = S + offset
    rng = np.random.default_rng(11)
    q = jnp.asarray(rng.standard_normal((B, S, cfg.num_heads, D)),
                    jnp.float32).astype(jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, T, cfg.num_kv_heads, D)),
                    jnp.float32).astype(jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, T, cfg.num_kv_heads, D)),
                    jnp.float32).astype(jnp.bfloat16)
    dense = np.asarray(_attention(q, k, v, offset, cfg)
                       .astype(jnp.float32))
    flash = np.asarray(_attention_flash(q, k, v, offset, cfg,
                                        qc=16, tc=16).astype(jnp.float32))
    assert np.allclose(dense, flash, atol=2e-2), \
        np.abs(dense - flash).max()
    # traced (non-static) offset goes through the masked-all-chunks path
    flash_tr = jax.jit(lambda *a: _attention_flash(*a, cfg, qc=16, tc=16)
                       )(q, k, v, jnp.int32(offset))
    assert np.allclose(dense, np.asarray(flash_tr.astype(jnp.float32)),
                       atol=2e-2)


def test_flash_attention_per_row_offset():
    """(B,) per-row offsets (continuous batching) through the flash path:
    each row must match the dense path run at its own scalar offset."""
    from qpalette_tpu.models.llama import _attention, _attention_flash
    cfg = CFG
    B, S, D = 2, 32, cfg.head_dim
    offs = np.array([0, 7], np.int32)
    T = S + int(offs.max())
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal((B, S, cfg.num_heads, D)),
                    jnp.float32).astype(jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, T, cfg.num_kv_heads, D)),
                    jnp.float32).astype(jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, T, cfg.num_kv_heads, D)),
                    jnp.float32).astype(jnp.bfloat16)
    flash = np.asarray(_attention_flash(q, k, v, jnp.asarray(offs), cfg,
                                        qc=16, tc=16).astype(jnp.float32))
    for b, off in enumerate(offs):
        dense_b = np.asarray(_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                        int(off), cfg).astype(jnp.float32))
        assert np.allclose(dense_b[0], flash[b], atol=2e-2), \
            np.abs(dense_b[0] - flash[b]).max()


def test_decode_matches_prefill(dense_setup):
    """Incremental decode with KV cache must match the full forward."""
    _, spec, params = dense_setup
    B, S = 2, 10
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(0, CFG.vocab_size, (B, S)), jnp.int32)
    full = np.asarray(forward(spec, params, toks))

    caches = init_kv_caches(spec, B, 16)
    logits_p, caches = prefill(spec, params, toks[:, :4], caches)
    assert np.allclose(np.asarray(logits_p), full[:, :4], atol=3e-2)
    from qpalette_tpu.models.llama import forward as fwd
    step_logits = []
    for i in range(4, S):
        lg, caches = fwd(spec, params, toks[:, i:i + 1],
                         kv_caches=caches, cache_pos=i)
        step_logits.append(np.asarray(lg)[:, 0])
    inc = np.stack(step_logits, axis=1)
    assert np.allclose(inc, full[:, 4:], atol=5e-2), \
        np.abs(inc - full[:, 4:]).max()


def test_generate_runs(dense_setup):
    _, spec, params = dense_setup
    prompt = np.array([[1, 2, 3]], dtype=np.int32)
    seq, stats = generate(spec, params, prompt, max_new_tokens=5,
                          max_seq=16, temperature=0.0)
    assert seq.shape == (1, 8)


def test_dummy_mode_builds(tmp_path):
    """--dummy latency mode: random packed weights, correct shapes only."""
    qspec, qparams = build_quantized_model(
        CFG, "tcomb_4_5_0.5_none_0.9", model_key="tiny_dummy",
        save_dir=str(tmp_path), dummy=True)
    toks = jnp.asarray(np.arange(8)[None, :] % CFG.vocab_size, jnp.int32)
    logits = forward(qspec, qparams, toks)
    assert np.isfinite(np.asarray(logits)).all()


def test_generate_fast_matches_generate(dense_setup):
    """Scan-based generation must produce valid tokens (greedy determinism
    check against the python-loop path)."""
    from qpalette_tpu.runtime.decode import generate_fast
    _, spec, params = dense_setup
    prompt = np.array([[1, 2, 3]], dtype=np.int32)
    seq_f, stats = generate_fast(spec, params, prompt, max_new_tokens=6,
                                 max_seq=16, temperature=0.0)
    seq_s, _ = generate(spec, params, prompt, max_new_tokens=6,
                        max_seq=16, temperature=0.0)
    assert seq_f.shape == seq_s.shape == (1, 9)
    assert np.array_equal(seq_f, seq_s), (seq_f, seq_s)


def test_quantized_kv_cache_decode(dense_setup):
    """int8 KV cache decode must track the bf16-cache decode closely."""
    _, spec, params = dense_setup
    B, S = 1, 8
    rng = np.random.default_rng(3)
    toks = jnp.asarray(rng.integers(0, CFG.vocab_size, (B, S)), jnp.int32)
    from qpalette_tpu.models.llama import forward as fwd
    c16 = init_kv_caches(spec, B, 16)
    c8 = init_kv_caches(spec, B, 16, quantized=True)
    l16, c16 = fwd(spec, params, toks, kv_caches=c16, cache_pos=0)
    l8, c8 = fwd(spec, params, toks, kv_caches=c8, cache_pos=0)
    a, b = np.asarray(l16), np.asarray(l8)
    rel = np.mean((a - b) ** 2) / (np.mean(a ** 2) + 1e-9)
    assert rel < 1e-3, rel
    # one more incremental step
    nxt = toks[:, :1]
    l16b, _ = fwd(spec, params, nxt, kv_caches=c16, cache_pos=S)
    l8b, _ = fwd(spec, params, nxt, kv_caches=c8, cache_pos=S)
    rel = float(np.mean((np.asarray(l16b) - np.asarray(l8b)) ** 2)
                / (np.mean(np.asarray(l16b) ** 2) + 1e-9))
    assert rel < 1e-3, rel


def test_int8_lm_head_close_to_bf16(dense_setup, tmp_path):
    dp, _, _ = dense_setup
    q16, p16 = build_quantized_model(
        CFG, "ldlq_1_8_none_1.0", model_key="tiny_lm8",
        save_dir=str(tmp_path), dense_params=dp)
    q8, p8 = build_quantized_model(
        CFG, "ldlq_1_8_none_1.0", model_key="tiny_lm8",
        save_dir=str(tmp_path), dense_params=dp, lm_head_bits=8)
    assert "lm_head_q" in p8 and "lm_head" not in p8
    toks = jnp.asarray(np.arange(4)[None, :] % CFG.vocab_size, jnp.int32)
    l16 = np.asarray(forward(q16, p16, toks))
    l8 = np.asarray(forward(q8, p8, toks))  # decode-sized rows
    rel = np.abs(l8 - l16).max() / (np.abs(l16).max() + 1e-9)
    assert rel < 0.02, rel
    # prefill/eval branch (rows > 8)
    toks2 = jnp.asarray(np.arange(16)[None, :] % CFG.vocab_size, jnp.int32)
    l16b = np.asarray(forward(q16, p16, toks2))
    l8b = np.asarray(forward(q8, p8, toks2))
    rel2 = np.abs(l8b - l16b).max() / (np.abs(l16b).max() + 1e-9)
    assert rel2 < 0.02, rel2


@pytest.mark.parametrize("lm_head_bits", [4, 8])
def test_kernel_impl_matches_plain_bench_mix(lm_head_bits):
    """impl=pallas (decode-GEMV kernel at decode rows) and impl=xla
    (decode + matmul) on the same params of the bench mix (merged
    tcq2s_6/tcq2s_8, quantized lm_head) give the same logits up to bf16
    activation rounding."""
    from qpalette_tpu.runtime.loader import sum2mix_qdict, with_impl
    spec, params = build_quantized_model(
        CFG, sum2mix_qdict(CFG.num_layers),
        merge_info=[["merge_qkv", "merge_ug"]] * CFG.num_layers,
        dummy=True, impl="pallas", lm_head_bits=lm_head_bits)
    assert {ls.impl for _, ls in spec.layers[0][0].projs} == {"pallas"}
    toks = jnp.asarray(np.arange(4)[None, :] % CFG.vocab_size, jnp.int32)
    got = np.asarray(forward(spec, params, toks), np.float32)
    ref = np.asarray(forward(with_impl(spec, "xla"), params, toks),
                     np.float32)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2


@pytest.mark.slow  # >35 s interpret-mode
def test_lm_head_4bit_trellis(dense_setup, tmp_path):
    """4-bit tcq2s lm_head (lm_head_bits=4): decode + prefill logits
    track the bf16 head, and ce_loss agrees with forward()'s own CE."""
    dp, _, _ = dense_setup
    q16, p16 = build_quantized_model(
        CFG, "ldlq_1_8_none_1.0", model_key="tiny_lm4",
        save_dir=str(tmp_path), dense_params=dp)
    q4, p4 = build_quantized_model(
        CFG, "ldlq_1_8_none_1.0", model_key="tiny_lm4",
        save_dir=str(tmp_path), dense_params=dp, lm_head_bits=4)
    assert q4.lm_head_spec is not None and "lm_head_q4" in p4
    toks = jnp.asarray(np.arange(16)[None, :] % CFG.vocab_size, jnp.int32)
    c16 = float(ce_loss(q16, p16, toks))
    c4 = float(ce_loss(q4, p4, toks))
    assert abs(c16 - c4) < 0.05, (c16, c4)
    # ce_loss == CE-from-forward-logits on the q4 path
    logits = np.asarray(forward(q4, p4, toks), np.float32)
    logp = jax.nn.log_softmax(jnp.asarray(logits[:, :-1]), axis=-1)
    ref = float(-jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(np.asarray(toks)[:, 1:])[..., None], axis=-1)))
    assert abs(c4 - ref) < 2e-3, (c4, ref)


def test_ce_loss_matches_forward_with_int8_lm_head(dense_setup, tmp_path):
    """ce_loss must slice off the padded-vocab columns AND rotate the
    hidden states into the int8 lm_head's incoherence basis — i.e. agree
    with the CE computed from forward()'s own logits (which do both)."""
    dp, _, _ = dense_setup
    spec, params = build_quantized_model(
        CFG, "ldlq_1_8_none_1.0", model_key="tiny_lm8",
        save_dir=str(tmp_path), dense_params=dp, lm_head_bits=8)
    toks = jnp.asarray(np.arange(16)[None, :] % CFG.vocab_size, jnp.int32)
    logits = np.asarray(forward(spec, params, toks), np.float32)
    logp = jax.nn.log_softmax(jnp.asarray(logits[:, :-1]), axis=-1)
    tgt = np.asarray(toks)[:, 1:]
    ref = float(-jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(tgt)[..., None], axis=-1)))
    got = float(ce_loss(spec, params, toks))
    assert abs(got - ref) < 1e-3, (got, ref)


def test_per_layer_impl_flag_honored(tmp_path):
    """qdict (qstr, impl) tuples must produce per-projection LinearSpecs
    with that impl (the solver's kernel-choice dimension, reference simt
    semantics — measure_latency_merge_simt.py:60-105)."""
    from qpalette_tpu.runtime.loader import LAYER_KEYS
    qd = {}
    for i in range(CFG.num_layers):
        for key in LAYER_KEYS:
            if key == "mlp.down_proj":
                qd[f"{i}_{key}"] = ("tcq1_3_none_0.9", "xla")
            elif key == "self_attn.o_proj":
                qd[f"{i}_{key}"] = ("tcq1_3_none_0.9", "1")  # alternate
            else:
                qd[f"{i}_{key}"] = ("tcq1_3_none_0.9", "0")  # default
    spec, params = build_quantized_model(
        CFG, qd, model_key="tiny_simt", save_dir=str(tmp_path),
        dummy=True, impl="pallas")
    aspec, mspec = spec.layers[0]
    projs = dict(aspec.projs)
    mprojs = dict(mspec.projs)
    assert projs["q"].impl == "pallas"          # "0" -> session default
    assert projs["o"].impl == "xla"             # "1" -> alternate class
    assert mprojs["down"].impl == "xla"         # explicit name verbatim
    assert mprojs["up"].impl == "pallas"
    toks = jnp.asarray(np.arange(8)[None, :] % CFG.vocab_size, jnp.int32)
    assert np.isfinite(np.asarray(forward(spec, params, toks))).all()


def test_hess_quantizers_through_loader(dense_setup, tmp_path):
    """`_hess_` quantizers receive calibration Hessians via
    build_quantized_model(hess=...) (eval_qdict --hess_path plumb)."""
    dp, _, _ = dense_setup
    rng = np.random.default_rng(14)
    hess = {}
    for i in range(CFG.num_layers):
        for g, n in (("qkv", CFG.hidden_size), ("o", CFG.hidden_size),
                     ("up", CFG.hidden_size),
                     ("down", CFG.intermediate_size)):
            X = rng.standard_normal((4 * n, n)).astype(np.float32)
            hess[f"{i}_{g}"] = X.T @ X / (4 * n)
    spec, params = build_quantized_model(
        CFG, "ldlq_1_4_hess_1.0", model_key="tiny_hess",
        save_dir=str(tmp_path), dense_params=dp, hess=hess)
    toks = jnp.asarray(np.arange(8)[None, :] % CFG.vocab_size, jnp.int32)
    lq = forward(spec, params, toks)
    assert np.isfinite(np.asarray(lq)).all()
