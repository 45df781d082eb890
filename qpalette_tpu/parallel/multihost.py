"""Multi-host distribution: jax.distributed init + DCN-aware meshes.

Reference behavior being replaced: the reference is single-node (its
NCCL/MPI hooks are vestigial); SURVEY §2.12 maps its TP/DP intent to JAX.
Scaling past one host means:

  * one JAX PROCESS per host, joined through ``jax.distributed.initialize``
    (GRPC coordinator) so all hosts share one global device list;
  * a mesh whose OUTER axis maps to the data-center network (DCN) between
    hosts and whose INNER axes stay within a host (NVLink between the
    cards of one host) — collectives on the inner axes (tensor-parallel
    psums, o/down row-parallel reductions) stay on the host; only
    data-parallel token traffic crosses DCN;
  * partition specs that replicate weights across the DCN axis (each host
    streams its full quantized copy — decode is bandwidth-bound, so
    weight replication is the right trade at 8B scale) and shard the
    batch.

Four cards of one host need none of this (ROADMAP C9).  Tested via 2 CPU
processes x 4 virtual devices each:
tests/test_multihost.py launches real subprocesses with a coordinator and
asserts a decode step matches the single-process result.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qpalette_tpu.parallel import tp as tp_mod


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join this process into a multi-host JAX job.

    All arguments default from the standard env vars
    (QPT_COORDINATOR / QPT_NUM_PROCESSES / QPT_PROCESS_ID), falling back
    to jax.distributed's own auto-detection (cluster environments it
    recognises; elsewhere all three are required)."""
    kw = {}
    addr = coordinator_address or os.environ.get("QPT_COORDINATOR")
    if addr:
        kw["coordinator_address"] = addr
    npz = num_processes if num_processes is not None else \
        os.environ.get("QPT_NUM_PROCESSES")
    if npz is not None:
        kw["num_processes"] = int(npz)
    pid = process_id if process_id is not None else \
        os.environ.get("QPT_PROCESS_ID")
    if pid is not None:
        kw["process_id"] = int(pid)
    jax.distributed.initialize(**kw)


def dcn_mesh(tp: int, dp: Optional[int] = None,
             devices=None) -> Mesh:
    """Mesh with axes ('dp', 'tp'): 'dp' (outer) crosses hosts over DCN,
    'tp' (inner) stays within a host.

    Devices are ordered process-major (jax.devices() already groups by
    process), so rows of the (dp, tp) grid never straddle a host unless
    tp > local device count (asserted)."""
    devices = list(jax.devices() if devices is None else devices)
    n = len(devices)
    if dp is None:
        dp = n // tp
    assert dp * tp == n, (dp, tp, n)
    if jax.process_count() > 1:
        assert tp <= jax.local_device_count(), (
            f"tp={tp} must fit within one host "
            f"({jax.local_device_count()} local devices) so tensor-"
            f"parallel collectives stay within a host, not on DCN")
    arr = np.array(devices).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


def shard_model_dcn(params, spec, mesh: Mesh):
    """Place quantized-model params on a (dp, tp) DCN mesh: weights are
    replicated across 'dp' (each host streams its own copy) and sharded
    across 'tp' exactly as the single-host TP placement."""
    tpn = mesh.shape["tp"]
    if tpn > 1:
        params = tp_mod.shard_interleave_merged(params, spec, tpn)
    pspecs = tp_mod.param_pspecs(spec, params, axis="tp")
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        params, pspecs, is_leaf=lambda x: isinstance(x, P)), pspecs


def dp_batch_spec() -> P:
    """Tokens (B, T): batch sharded over the DCN data-parallel axis."""
    return P("dp", None)


def dcn_forward_fn(spec, mesh: Mesh, params, with_cache: bool = False):
    """jit-able forward over the (dp, tp) mesh: data parallel over hosts,
    tensor parallel within a host.  Mirrors tp.tp_forward_fn but with the
    batch dimension sharded over 'dp' and KV caches sharded (dp, heads)."""
    from qpalette_tpu.models import llama
    tpn = mesh.shape["tp"]
    lspec = tp_mod.localize_spec(spec, tpn, "tp") if tpn > 1 else spec
    pspecs = tp_mod.param_pspecs(spec, params, axis="tp")

    if not with_cache:
        def body(params, tokens):
            return llama.forward(lspec, params, tokens)

        return jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(pspecs, dp_batch_spec()),
            out_specs=dp_batch_spec(), check_vma=False))

    def body(params, tokens, kv_caches, cache_pos):
        return llama.forward(lspec, params, tokens, kv_caches=kv_caches,
                             cache_pos=cache_pos)

    kvspec = [(P("dp", None, "tp", None), P("dp", None, "tp", None))
              for _ in range(spec.config.num_layers)]
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(pspecs, dp_batch_spec(), kvspec, P()),
        out_specs=(dp_batch_spec(), kvspec), check_vma=False))
