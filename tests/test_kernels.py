"""Decode-GEMV kernel and plain XLA path vs the executable-spec decoders.

The kernel runs in the Pallas interpreter here (conftest requests it with
QPALETTE_INTERPRET=1); on the card it compiles through Triton, which the
`gpu`-marked test at the end checks.  References are the ops/packing spec
decoders over the codebook tables of ops/codebooks, in float64.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qpalette_tpu.kernels import formats as kf
from qpalette_tpu.kernels import trellis_gemv as tg
from qpalette_tpu.ops import packing
from qpalette_tpu.ops.codebooks import (tlut_bits_for_kv, trellis_lut,
                                        trellis_lut_arith, vq_lut)
from qpalette_tpu.runtime import qlinear
from qpalette_tpu.runtime.qlinear import LinearSpec

ARITH = [("1mad", 3), ("2mad", 4), ("dualmad", 5), ("sum2", 6), ("sum2", 7)]


def _arith_case(mode, KV, m, k, seed):
    """Random canonical trellis words + the spec's dense W (m, k)."""
    V = tg.mode_v(mode)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, ((m // 16) * (k // 16), 8 * KV // V),
                         dtype=np.uint32)
    lut = jnp.asarray(trellis_lut_arith(mode))
    if V == 1:
        W = packing.dequant_tcq(jnp.asarray(words), lut, m, k, KV, v=1)
    else:
        W = packing.dequant_tcq2(jnp.asarray(words), lut, m, k, KV)
    return words, np.asarray(W, np.float64)


# m/16 = 3 and k/16 = 5 (48 x 80) leave no power-of-two block above one
# tile and an uneven k-split: the kernel's smallest-block fallback
@pytest.mark.parametrize("m,k", [(64, 128), (48, 80)])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("mode,KV", ARITH)
def test_gemv_kernel_matches_spec(mode, KV, rows, m, k):
    words, W = _arith_case(mode, KV, m, k, seed=KV * 7 + rows)
    rng = np.random.default_rng(rows)
    x = jnp.asarray(rng.standard_normal((rows, k)), jnp.bfloat16)
    ref = np.asarray(x, np.float64) @ W.T
    y = np.asarray(tg.decode_gemv(x, kf.trellis_kt(words, m, k), KV, mode,
                                  m, k))
    assert y.shape == (rows, m)
    # exact integer weights x bf16 inputs: only the f32 summation differs
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("bm,ks", [(1, 1), (2, 3), (4, 8)])
def test_gemv_kernel_block_configs(bm, ks):
    """Every m-block width and k-split gives the same product (k-split
    partials are summed outside the kernel)."""
    m, k, KV = 64, 128, 6
    words, W = _arith_case("sum2", KV, m, k, seed=3)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((2, k)),
                    jnp.bfloat16)
    ref = np.asarray(x, np.float64) @ W.T
    y = np.asarray(tg.decode_gemv(x, kf.trellis_kt(words, m, k), KV, "sum2",
                                  m, k, bm=bm, ks=ks))
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_block_config_heuristic():
    # 8B shapes: 32 m-tiles per program, k split to ~528 programs
    assert tg.block_config(6144, 4096) == (32, 44)
    assert tg.block_config(131072, 4096) == (32, 3)
    assert tg.block_config(4096, 14336) == (32, 66)
    # odd tile counts fall back to the largest power-of-two divisor
    assert tg.block_config(48, 80) == (1, 5)
    with pytest.raises(AssertionError):
        tg.block_config(48, 80, bm=2)


def _plain_case(kind, rng):
    """(spec, params, luts, W_ref (m, k)) for one kind at a tiny shape."""
    m, k = 64, 128
    if kind in ("tcq1_1mad", "tcq1_2mad", "tcq2_dualmad", "tcq2_sum2"):
        base, mode = kind.split("_")
        KV = {"1mad": 3, "2mad": 4, "dualmad": 5, "sum2": 7}[mode]
        words, W = _arith_case(mode, KV, m, k, seed=11)
        spec = LinearSpec(base, k, m, KV=(KV,), mode=mode)
        return spec, {"trellis_kt": kf.trellis_kt(words, m, k)}, {}, W
    if kind == "vq":
        bits, vec = 4, 2
        idx = rng.integers(0, 1 << bits, (m, k // vec))
        packed = packing.pack_rows(jnp.asarray(idx), bits)
        lut = np.asarray(vq_lut(bits, vec, n_samples=1 << 14))
        W = packing.dequant_lut(packed, jnp.asarray(lut), m, k, bits, vec)
        spec = LinearSpec("vq", k, m, bits=bits, vec=vec)
        p = {"qweight_t": kf.vq_words(packed, bits, vec, k),
             "lut": jnp.asarray(lut)}
        return spec, p, {}, np.asarray(W, np.float64)
    KV1, KV2 = 4, 5
    S = tlut_bits_for_kv(KV2)
    lut = jnp.asarray(trellis_lut(S))
    luts = {f"tcq{S}": lut}

    def tiles(mm, kk, KV):
        return rng.integers(0, 1 << 32, ((mm // 16) * (kk // 16), 4 * KV),
                            dtype=np.uint32)
    if kind == "tcq":
        t = tiles(m, k, KV1)
        W = packing.dequant_tcq(jnp.asarray(t), lut, m, k, KV1)
        spec = LinearSpec("tcq", k, m, KV=(KV1,), tlut_bits=S)
        return spec, {"trellis_kt": kf.trellis_kt(t, m, k)}, luts, \
            np.asarray(W, np.float64)
    if kind == "tcomb":  # input split
        n1 = n2 = k // 2
        t1, t2 = tiles(m, n1, KV1), tiles(m, n2, KV2)
        W = jnp.concatenate([packing.dequant_tcq(jnp.asarray(t1), lut, m,
                                                 n1, KV1),
                             packing.dequant_tcq(jnp.asarray(t2), lut, m,
                                                 n2, KV2)], axis=1)
        spec = LinearSpec("tcomb", k, m, KV=(KV1, KV2), tlut_bits=S,
                          split=(n1, n2))
        p = {"trellis1_kt": kf.trellis_kt(t1, m, n1),
             "trellis2_kt": kf.trellis_kt(t2, m, n2)}
        return spec, p, luts, np.asarray(W, np.float64)
    assert kind == "comb"  # output split
    m1 = m2 = m // 2
    t1, t2 = tiles(m1, k, KV1), tiles(m2, k, KV2)
    W = jnp.concatenate([packing.dequant_tcq(jnp.asarray(t1), lut, m1, k,
                                             KV1),
                         packing.dequant_tcq(jnp.asarray(t2), lut, m2, k,
                                             KV2)], axis=0)
    spec = LinearSpec("comb", k, m, KV=(KV1, KV2), tlut_bits=S,
                      split=(m1, m2))
    p = {"trellis1_kt": kf.trellis_kt(t1, m1, k),
         "trellis2_kt": kf.trellis_kt(t2, m2, k)}
    return spec, p, luts, np.asarray(W, np.float64)


PLAIN_KINDS = ["tcq1_1mad", "tcq1_2mad", "tcq2_dualmad", "tcq2_sum2", "vq",
               "tcq", "tcomb", "comb"]


@pytest.mark.parametrize("kind", PLAIN_KINDS)
def test_plain_dequant_matches_spec(kind):
    """The XLA path's decode from the device layout == the spec decoders
    (exactly: both produce the same f32 codebook values)."""
    spec, p, luts, W = _plain_case(kind, np.random.default_rng(5))
    Wt = np.asarray(qlinear.dequant_weight_t(spec, p, luts))
    assert Wt.shape == (spec.in_features, spec.out_features)
    np.testing.assert_allclose(Wt.T, W, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["tcq2_sum2", "vq"])
def test_plain_apply_f32_is_exact_reference(kind):
    """impl='xla' on f32 activations decodes in f32: the product equals
    the spec weight's product to f32 rounding (the f32 model reference)."""
    spec, p, luts, W = _plain_case(kind, np.random.default_rng(6))
    p = dict(p, wscale=jnp.full((spec.out_features,), 0.5, jnp.float32))
    x = np.random.default_rng(7).standard_normal((5, spec.in_features))
    with jax.default_matmul_precision("highest"):
        y = np.asarray(qlinear.qlinear_apply(spec, p,
                                             jnp.asarray(x, jnp.float32)))
    ref = 0.5 * (x @ W.T)
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("extra", [0, 1])
def test_dispatch_at_row_cutoff(monkeypatch, extra):
    """impl='pallas' runs the kernel up to GEMV_MAX_ROWS rows and the
    decode-then-matmul path above; both give the same rows."""
    spec, p, _, W = _plain_case("tcq2_sum2", np.random.default_rng(8))
    spec = LinearSpec(spec.kind, spec.in_features, spec.out_features,
                      KV=spec.KV, mode=spec.mode, impl="pallas")
    p = dict(p, wscale=jnp.ones((spec.out_features,), jnp.float32))
    calls = []
    real = tg.decode_gemv
    monkeypatch.setattr(tg, "decode_gemv",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rows = qlinear.GEMV_MAX_ROWS + extra
    x = jnp.asarray(np.random.default_rng(9).standard_normal(
        (rows, spec.in_features)), jnp.bfloat16)
    y = np.asarray(qlinear.qlinear_apply(spec, p, x, out_dtype=jnp.float32))
    assert len(calls) == (0 if extra else 1)
    ref = np.asarray(x, np.float64) @ W.T
    # both paths multiply exact integer byte sums by the bf16 inputs
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_impl_resolution():
    """The loader records the path each kind takes: the kernel only for
    the arithmetic trellis kinds; asking it of another kind is an error."""
    assert qlinear.resolve_impl("tcq2", "pallas") == "pallas"
    assert qlinear.resolve_impl("tcq1", "pallas") == "pallas"
    for kind in ("tcq", "tcomb", "comb", "vq"):
        assert qlinear.resolve_impl(kind, "pallas") == "xla"
    with pytest.raises(ValueError):
        qlinear.resolve_impl("tcq2", "pallas_a8")
    spec, p, luts, _ = _plain_case("vq", np.random.default_rng(1))
    bad = LinearSpec("vq", spec.in_features, spec.out_features,
                     bits=spec.bits, vec=spec.vec, impl="pallas")
    p = dict(p, wscale=jnp.ones((spec.out_features,), jnp.float32))
    with pytest.raises(ValueError):
        qlinear.qlinear_apply(bad, p, jnp.ones((1, spec.in_features)))


def test_kernel_without_interpret_request_raises(monkeypatch):
    """Off the GPU the kernel runs only when the interpreter is asked for;
    it never falls back to it silently."""
    monkeypatch.delenv("QPALETTE_INTERPRET", raising=False)
    words, _ = _arith_case("sum2", 6, 64, 128, seed=0)
    x = jnp.ones((1, 128), jnp.bfloat16)
    with pytest.raises(RuntimeError, match="QPALETTE_INTERPRET"):
        tg.decode_gemv(x, kf.trellis_kt(words, 64, 128), 6, "sum2", 64, 128)


@pytest.mark.parametrize("KV,V", [(5, 2), (6, 2), (7, 2), (9, 2), (3, 1),
                                  (4, 1)])
def test_trellis_layout_is_nominal_and_invertible(KV, V):
    """(k/16, words, m/16) holds exactly KV/V bits per weight for every KV
    and is a pure relayout of the canonical tile stream."""
    m, k = 64, 96
    words = np.random.default_rng(KV).integers(
        0, 1 << 32, ((m // 16) * (k // 16), kf.trellis_words_per_tile(KV, V)),
        dtype=np.uint32)
    tr = kf.trellis_kt(words, m, k)
    assert tr.shape == (k // 16, 8 * KV // V, m // 16)
    assert tr.size * 32 == m * k * KV // V
    back = np.asarray(tr).transpose(2, 0, 1).reshape(words.shape)
    np.testing.assert_array_equal(back, words)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_path_rule(monkeypatch, tmp_path, env_set):
    from qpalette_tpu.utils import compile_cache as cc
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cc.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cc.cache_dir() == os.path.join(cc.REPO_ROOT, ".jax_cache")
        assert os.path.isfile(os.path.join(cc.REPO_ROOT, "chip_smoke.py"))


def test_unknown_device_kind_is_an_error():
    from qpalette_tpu.utils.device import PEAKS, peaks
    assert peaks("NVIDIA H100 80GB HBM3") is PEAKS["NVIDIA H100 80GB HBM3"]
    with pytest.raises(ValueError, match="device_kind"):
        peaks("NVIDIA A100-SXM4-80GB")


def test_require_gpu_refuses_cpu():
    from qpalette_tpu.utils.device import require_gpu
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


@pytest.mark.gpu
def test_gemv_kernel_compiled_on_card(gpu):
    """The compiled kernel (no interpreter) agrees with the f32 reference
    at an 8B projection width."""
    m, k, KV = 4096, 4096, 6
    words, W = _arith_case("sum2", KV, m, k, seed=0)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, k)),
                    jnp.bfloat16)
    ref = np.asarray(x, np.float64) @ W.T
    y = np.asarray(tg.decode_gemv(x, kf.trellis_kt(words, m, k), KV, "sum2",
                                  m, k))
    assert np.abs(y - ref).max() <= 1e-3 * np.abs(ref).max()
