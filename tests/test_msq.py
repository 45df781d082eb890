import numpy as np
import pytest

from qpalette_tpu.models.llama import LlamaConfig
from qpalette_tpu.msq.memmodel import (calc_avg_bits, layer_mem_bytes,
                                       LAYER_KEYS)
from qpalette_tpu.msq.solver import (QDICT_MEM, QDICT_LAT,
                                     solve_mem_constrained,
                                     solve_lat_constrained, MERGE_GROUPS,
                                     SIMPLE2KEY)

CFG = LlamaConfig.llama31_8b()


def _fake_err_table(qlist):
    # monotone: more bits -> less err (2^-2R shape like the real table)
    out = {}
    for q in qlist:
        from qpalette_tpu.quant.incoherent import parse_quantizer_str
        R = parse_quantizer_str(q).avg_bits
        out[q] = float(2.0 ** (-2.0 * R))
    return out


def test_err_coeffs_pipeline_feeds_solver():
    """Synthetic-calibration sensitivity pipeline end-to-end on a tiny
    model: group-energy pass -> err_coeffs (tr(H)/n · mean W², the
    documented formula) -> solve_mem_constrained consumes them and the
    solution SHIFTS relative to uniform sensitivity.  Locks the
    assets/{model}_err_coeffs.json schema (reference
    assets/3_8b_err_coeffs.pt, consumed solve_mem_const.py:137-139)."""
    import jax.numpy as jnp
    from qpalette_tpu.runtime.loader import (build_dense_model,
                                             random_dense_params)
    from qpalette_tpu.quant.hessian import (collect_group_energy,
                                            err_coeffs_from_energy)
    cfg = LlamaConfig.tiny()
    dp = random_dense_params(cfg, seed=3)
    # break the layer symmetry so sensitivity actually varies
    for i, lp in enumerate(dp["layers"]):
        lp["mlp.down_proj"] = lp["mlp.down_proj"] * (1.0 + 2.0 * i)
    spec, params = build_dense_model(cfg, dp)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (1, 32)).astype(np.int32)]
    energy = collect_group_energy(spec, params, batches)
    assert len(energy) == cfg.num_layers * 4
    coeffs = err_coeffs_from_energy(energy, dp, cfg.num_layers)
    assert len(coeffs) == cfg.num_layers * 7
    assert abs(np.mean(list(coeffs.values())) - 1.0) < 1e-6
    # down_proj of the boosted layer must be more sensitive
    assert coeffs[f"{cfg.num_layers - 1}_mlp.down_proj"] > \
        coeffs["0_mlp.down_proj"]

    qlist = list(QDICT_MEM)
    errs = _fake_err_table(qlist)
    qd_u = solve_mem_constrained(cfg, qlist, errs, target_bits=3.0)
    qd_c = solve_mem_constrained(cfg, qlist, errs, target_bits=3.0,
                                 err_coeffs=coeffs)
    assert calc_avg_bits(cfg, qd_c) <= 3.0 + 1e-6
    assert qd_c != qd_u  # sensitivity moved bits between layers


def test_mem_model_matches_reference_values():
    # tcq_6 on q_proj (4096x4096): 3 bits/weight + tlut
    m = layer_mem_bytes(CFG, "self_attn.q_proj", "tcq_6_none_0.9")
    expect = 4096 * 4096 * 3 / 8 + (1 << 9) * 2 * 2
    assert m == expect
    # ldlq_2_6: lut_bits/vec = 3 bits + lut (reference mem_op.py:318-319)
    m = layer_mem_bytes(CFG, "mlp.down_proj", "ldlq_2_6_none_1.0")
    expect = 4096 * 14336 * 6 / 2 / 8 + (1 << 6) * 2 * 2
    assert m == expect


def test_solve_mem_constrained_meets_budget():
    qlist = list(QDICT_MEM)
    errs = _fake_err_table(qlist)
    qdict = solve_mem_constrained(CFG, qlist, errs, target_bits=3.25)
    assert len(qdict) == 32 * 7
    bits = calc_avg_bits(CFG, qdict)
    assert bits <= 3.25 + 1e-6
    assert bits > 2.5  # should use most of the budget
    # with a generous budget everything should pick the biggest quantizer
    qdict_hi = solve_mem_constrained(CFG, qlist, errs, target_bits=5.0)
    assert calc_avg_bits(CFG, qdict_hi) > bits


def _fake_lat_coeffs(qlist):
    """Synthetic per-group decode latency ~ bytes/bandwidth + fixed launch
    overhead per kernel (so fusing helps, as on real hardware)."""
    BW = 800e9
    launch = 3e-6
    coeffs = {"constant": 1.5e-3}
    groups = list("qkvougd") + list(MERGE_GROUPS)
    for g in groups:
        bases = MERGE_GROUPS.get(g, (g,))
        for q in qlist:
            mem = sum(layer_mem_bytes(CFG, SIMPLE2KEY[b], q) for b in bases)
            coeffs[f"{g}_{q}_False"] = launch + mem / BW
            if q.startswith("ldlq"):
                coeffs[f"{g}_{q}_True"] = 0.8 * launch + 1.1 * mem / BW
    return coeffs


@pytest.mark.slow  # 100 s: exact MILP cross-check
def test_solve_lat_constrained_fusion_aware():
    qlist = list(QDICT_LAT)
    errs = _fake_err_table(qlist)
    lat = _fake_lat_coeffs(qlist)
    sol = solve_lat_constrained(CFG, qlist, errs, lat, target_thp=200.0,
                                use_impl_choice=True)
    assert sol.est_latency <= 1.0 / 200.0 + 1e-9
    assert len(sol.qdict) == 32 * 7
    assert len(sol.merge_info) == 32
    # with per-kernel launch overhead, fusing should be chosen
    assert any(mi for mi in sol.merge_info), "expected some merges"

    # a higher throughput target forces lower bits => higher error
    sol_fast = solve_lat_constrained(CFG, qlist, errs, lat,
                                     target_thp=300.0)
    assert sol_fast.est_err >= sol.est_err - 1e-12

    # no_fuse must not produce merges
    sol_nf = solve_lat_constrained(CFG, qlist, errs, lat, target_thp=200.0,
                                   no_fuse=True)
    assert all(not mi for mi in sol_nf.merge_info)
    assert sol_nf.est_err >= sol.est_err - 1e-12


def test_solver_output_loadable_by_loader():
    """Solver output schema plugs straight into build_quantized_model."""
    from qpalette_tpu.runtime.loader import build_quantized_model
    cfg = LlamaConfig.tiny()
    qlist = ["tcq_4_none_0.9", "tcomb_4_5_0.5_none_0.9"]
    errs = _fake_err_table(qlist)
    lat = {"constant": 0.0}
    from qpalette_tpu.msq.solver import MERGE_GROUPS as MG
    for g in list("qkvougd") + list(MG):
        for q in qlist:
            lat[f"{g}_{q}_False"] = 1e-5
    sol = solve_lat_constrained(cfg, qlist, errs, lat, target_thp=100.0,
                                num_layers=cfg.num_layers)
    spec, params = build_quantized_model(
        cfg, sol.qdict, merge_info=sol.merge_info, dummy=True)
    assert spec is not None


def test_proxy_err_matches_reference_published():
    """Data-free proxy errors must land near the reference's published
    table (assets/quant_err.pt: ldlq_1_4 -> 0.00950, ldlq_2_6 -> 0.02972,
    measured on 4096x4096; we use 512x512 so allow sampling slack)."""
    from qpalette_tpu.msq.err_tables import quantizer_proxy_err
    e14 = quantizer_proxy_err("ldlq_1_4_none_1.0", size=512)
    assert abs(e14 - 0.00950) / 0.00950 < 0.15, e14
    e26 = quantizer_proxy_err("ldlq_2_6_none_1.0", size=512)
    assert abs(e26 - 0.02972) / 0.02972 < 0.15, e26


@pytest.mark.skipif(not __import__("os").environ.get("QPT_SLOW"),
                    reason="~1 min CPU viterbi")
def test_tcq_proxy_err_matches_reference_published():
    """TCQ proxy errors vs reference assets/quant_err.pt: tcq_6 -> 0.01891,
    tcomb_6_7 -> 0.01455 (the headline 3.25-bit scheme).  Measured here at
    256x256 (reference used 4096x4096): observed 0.01456 vs 0.01455."""
    from qpalette_tpu.msq.err_tables import quantizer_proxy_err
    e = quantizer_proxy_err("tcomb_6_7_0.5_none_0.9", size=256)
    assert abs(e - 0.01455) / 0.01455 < 0.12, e


def test_latmodel_fit_and_table():
    from qpalette_tpu.msq.latmodel import (fit_family_model, build_lat_table,
                                           parse_samples_output)
    text = """OH 1000.0
VQ 4 1 4096 4096 110.0
VQ 6 2 4096 14336 260.0
TCQ 6 9 4096 2048 240.0
TCQ 6 9 14336 2048 700.0
"""
    samples = parse_samples_output(text, CFG)
    assert len(samples) == 4
    fp = fit_family_model(samples)
    assert set(fp) == {"vq", "tcq"}
    table = build_lat_table(CFG, list(QDICT_LAT), fp)
    # full schema coverage for the solver
    from qpalette_tpu.msq.solver import MERGE_GROUPS
    for g in list("qkvougd") + list(MERGE_GROUPS):
        for q in QDICT_LAT:
            assert f"{g}_{q}_False" in table
    # more bytes -> more time
    assert table["d_ldlq_2_12_none_1.0_False"] > \
        table["d_ldlq_2_3_none_1.0_False"]
    # feeds the solver end-to-end
    errs = _fake_err_table(list(QDICT_LAT))
    sol = solve_lat_constrained(CFG, list(QDICT_LAT), errs, table,
                                target_thp=20.0)
    assert sol.qdict


def test_lat_milp_exact_vs_lagrangian():
    """Exact HiGHS MILP (reference solve_lat_const.py formulation) must be
    feasible and at least as good as the Lagrangian decomposition."""
    qlist = list(QDICT_LAT)[:12]
    errs = _fake_err_table(qlist)
    lat = _fake_lat_coeffs(qlist)
    target = 1.0 / (32 * 7 * 2e-5)  # loose-ish target
    sol_ex = solve_lat_constrained(CFG, qlist, errs, lat, target,
                                   num_layers=4, exact=True)
    sol_lg = solve_lat_constrained(CFG, qlist, errs, lat, target,
                                   num_layers=4, exact=False)
    limit = 1.0 / target
    assert sol_ex.est_latency <= limit + 1e-9
    assert sol_lg.est_latency <= limit + 1e-9
    assert sol_ex.est_err <= sol_lg.est_err + 1e-12, \
        (sol_ex.est_err, sol_lg.est_err)
    # coverage: every proj assigned exactly once per layer
    assert len(sol_ex.qdict) == 4 * 7
