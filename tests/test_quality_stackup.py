"""Quality stack-up regression.

The committed asset (assets/quality_stackup.json, generated by
scripts/quality_stackup.py on an H100 at Llama-3.2-1B scale with
fixed-seed dummy weights) pins the CE/logit deltas of the lm_head variants
the decode configuration stacks on the quantized decoder.

test_asset_bounds asserts the committed numbers stay inside the bands:
  * the int8 lm_head is a ~1% mean-logit effect;
  * the 4-bit trellis lm_head is the one material quality trade: ~17-18%
    mean relative logit perturbation — consistent with tcq2s_8's ~0.02
    normalized MSE (sqrt(0.02) ~ 14% weight RMS error).
Anyone regenerating the asset after touching the kernels/loader must
stay inside these bands or consciously widen them.

test_tiny_stackup_runs re-runs the generator at tiny scale on CPU
(slow tier) so the script itself stays executable.
"""

import json
import os

import pytest

ASSET = os.path.join(os.path.dirname(__file__), "..",
                     "assets", "quality_stackup.json")


def test_asset_bounds():
    res = json.load(open(ASSET))
    assert res["config"] == "3_1b" and res["layers"] == 16
    assert res["device"]["kind"] == "NVIDIA H100 80GB HBM3"

    b = res["tcq2s_bench"]
    # bf16 head is the reference: identically zero deltas
    assert b["pallas_lm16"]["max_logit_delta_rel"] == 0.0
    # int8 lm_head: ~1% mean logit effect, CE moves < 0.02
    assert b["pallas_lm8"]["mean_logit_delta_rel"] < 0.03
    assert abs(b["pallas_lm8"]["ce_delta"]) < 0.02
    # 4-bit trellis lm_head: the material trade, ~0.18 mean rel.
    # perturbation at 1B dummy scale; must stay below 0.25
    assert b["pallas_lm4"]["mean_logit_delta_rel"] < 0.25

    t = res["tcomb_325"]
    assert t["pallas_lm16"]["max_logit_delta_rel"] == 0.0
    assert t["pallas_lm8"]["mean_logit_delta_rel"] < 0.01
    assert t["pallas_lm4"]["mean_logit_delta_rel"] < 0.25


@pytest.mark.slow
def test_tiny_stackup_runs(tmp_path, monkeypatch):
    from scripts.quality_stackup import run_stackup
    monkeypatch.setenv("QPALETTE_INTERPRET", "1")
    res = run_stackup("tiny", layers=None, seq=16)
    b = res["tcq2s_bench"]
    assert b["pallas_lm16"]["max_logit_delta_rel"] == 0.0
    # tiny shapes are noisier; just assert the ordering the asset pins:
    # the lm8 effect is small, lm4 is the big one
    assert b["pallas_lm8"]["mean_logit_delta_rel"] < 0.1
    assert (b["pallas_lm4"]["mean_logit_delta_rel"]
            >= b["pallas_lm8"]["mean_logit_delta_rel"])
