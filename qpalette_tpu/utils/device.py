"""The accelerator a measurement runs on: name it, or refuse to measure."""

from __future__ import annotations

import subprocess

# Published dense peaks by jax device_kind (NVIDIA H100 data sheet, SXM
# part, at its 700 W limit).  A device that is not listed is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "bf16_flops": 989e12, "int8_ops": 1979e12},
}


def peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise ValueError(f"no published peaks for device_kind "
                         f"{device_kind!r}; add them to utils/device.PEAKS")
    return PEAKS[device_kind]


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of the GPU JAX runs on; raises when
    JAX found no GPU (a measurement never falls back to the CPU)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi() -> str:
    """Name and power limit of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()
