"""Test config: CPU with 8 virtual devices by default, so sharding tests
run anywhere, with the decode-GEMV kernel in the Pallas interpreter
(requested explicitly through QPALETTE_INTERPRET=1).

Tests marked `gpu` need the card and skip elsewhere; whether a card is
present is decided in the `gpu` fixture, never at import.  On the card:

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    os.environ.setdefault("QPALETTE_INTERPRET", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; on the card run "
                    "`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`")
