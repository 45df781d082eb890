"""Solver size-model truthfulness: layer_mem_bytes must equal the bytes
the runtime actually streams (packed kernel arrays), within 1% — the
round-4 VERDICT #3 nominal-vs-packed gap (odd-KV tcq2/tcq2s streamed the
aligned 3 b/w while the solver billed 2.5).  With the dense odd-KV
double-tile layout the nominal bits ARE the stored bits."""

import numpy as np
import jax.numpy as jnp
import pytest

from qpalette_tpu.models.llama import LlamaConfig
from qpalette_tpu.msq.memmodel import layer_mem_bytes, layer_shape
from qpalette_tpu.runtime.loader import (dummy_artifact,
                                         _params_from_artifact)


@pytest.mark.parametrize("qstr", [
    "tcq2s_5_none_0.9", "tcq2s_6_none_0.9", "tcq2s_7_none_0.9",
    "tcq2s_8_none_0.9", "tcq2s_9_none_0.9", "tcq2_5_none_0.9",
    "tcq1_3_none_0.9", "tcq1_4_none_0.9", "tcq_6_none_0.9",
    "ldlq_2_6_none_1.0",
])
@pytest.mark.parametrize("key", ["self_attn.q_proj", "mlp.down_proj"])
def test_solver_bytes_match_streamed_bytes(qstr, key):
    cfg = LlamaConfig.llama32_1b()
    shape = layer_shape(cfg, key)
    art = dummy_artifact(qstr, shape, seed=0)
    p = _params_from_artifact(art, jnp.bfloat16)
    # packed stream = everything except the per-row scale epilogue and
    # (for LUT kinds) the shared codebook, which layer_mem_bytes bills
    # separately as the LUT term
    packed = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                 for k_, a in p.items() if k_ not in ("wscale",))
    model = layer_mem_bytes(cfg, key, qstr)
    assert abs(packed - model) / model < 0.01, (
        f"{qstr} {key}: streamed {packed} vs model {model} "
        f"({packed / model:.3f}x)")
