"""Test configuration: the CPU backend with 8 virtual devices.

The standard JAX recipe for testing shard_map sharding logic without a
multi-GPU host (SURVEY.md §4).  The platform is set through jax.config
before any backend starts.  Unless JAX_PLATFORMS names another platform,
tests run on the CPU, where Pallas kernels run in interpret mode.

Tests marked `gpu` need a card and skip elsewhere; the `gpu` fixture
decides at run time (never while modules are imported, so every test
worker collects the same tests).  On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest -m gpu")
    return device
