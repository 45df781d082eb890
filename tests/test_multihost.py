"""Multi-host distribution test: 2 real processes x 4 virtual CPU devices
joined via jax.distributed (GRPC coordinator), running one decode forward
over a (dp=2, tp=4) DCN-aware mesh — the SURVEY §2.12 / BASELINE 2-host
scaling surface, simulated on one host.

Each subprocess shards params over its mesh (weights replicated across
the DCN 'dp' axis, tensor-parallel over 'tp'), runs a forward on its
LOCAL batch shard, and writes logits; the parent compares against the
single-process reference."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, pickle, sys
import numpy as np
import jax

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
out_path = sys.argv[4]
jax.config.update("jax_platforms", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
sys.path.insert(0, %(repo)r)
os.environ["QPALETTE_INTERPRET"] = "1"

from qpalette_tpu.parallel.multihost import (init_distributed, dcn_mesh,
                                             shard_model_dcn,
                                             dcn_forward_fn, dp_batch_spec)
init_distributed(f"127.0.0.1:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 4 * nproc

from qpalette_tpu.models.llama import LlamaConfig
from qpalette_tpu.runtime.loader import build_quantized_model

cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_layers=2, num_heads=8, num_kv_heads=4, head_dim=32,
                  rope_theta=10000.0)
spec, params = build_quantized_model(
    cfg, "tcq2s_6_none_0.9", model_key="mh_test", dummy=True,
    impl="pallas", row_parallel_tp=4)
mesh = dcn_mesh(tp=4)
assert dict(mesh.shape) == {"dp": nproc, "tp": 4}
params_s, _ = shard_model_dcn(params, spec, mesh)
fwd = dcn_forward_fn(spec, mesh, params)

B, T = 2 * nproc, 5
rng = np.random.default_rng(0)
tokens_global = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
# build the globally-sharded token array from per-process local shards
from jax.sharding import NamedSharding
sh = NamedSharding(mesh, dp_batch_spec())
tokens = jax.make_array_from_callback(
    (B, T), sh, lambda idx: tokens_global[idx])
logits = fwd(params_s, tokens)
# gather the full result for comparison
full = np.asarray(jax.device_get(
    jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, jax.sharding.PartitionSpec()))(logits)))
if pid == 0:
    with open(out_path, "wb") as f:
        pickle.dump({"tokens": tokens_global, "logits": full}, f)
print("WORKER_OK", pid, flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.slow  # two subprocess JAX startups + interpret-mode forward
def test_two_process_dcn_mesh_matches_single(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"repo": REPO})
    out_path = str(tmp_path / "out.pkl")
    procs = []
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["JAX_PLATFORMS"] = "cpu"
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", str(port),
             out_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {pid}" in out, (
            f"worker {pid} failed:\n{out[-4000:]}")
    with open(out_path, "rb") as f:
        res = pickle.load(f)

    # single-process reference on the same tokens
    os.environ["QPALETTE_INTERPRET"] = "1"
    from qpalette_tpu.models.llama import LlamaConfig, forward
    from qpalette_tpu.runtime.loader import build_quantized_model
    cfg = LlamaConfig(vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=8,
                      num_kv_heads=4, head_dim=32, rope_theta=10000.0)
    spec, params = build_quantized_model(
        cfg, "tcq2s_6_none_0.9", model_key="mh_test", dummy=True,
        impl="pallas", row_parallel_tp=4)
    ref = np.asarray(forward(spec, params, res["tokens"]))
    got = res["logits"]
    assert got.shape == ref.shape
    denom = np.abs(ref).max() + 1e-9
    assert np.abs(got - ref).max() / denom < 5e-2, \
        np.abs(got - ref).max() / denom
