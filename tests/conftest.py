"""Test configuration.

The suite runs on the CPU with 8 virtual devices, so that multi-device
sharding logic is testable on any machine (SURVEY §4). Tests marked ``gpu``
need an NVIDIA GPU: they skip elsewhere, and ``python chip_smoke.py`` runs
them on the card (it sets ``GR4_TEST_PLATFORM=gpu``, which leaves JAX on its
default platform instead of pinning the CPU).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("GR4_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX runs on a GPU. Decided per
    test, never at import: every xdist worker must collect the same tests."""
    if request.node.get_closest_marker("gpu") \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` there")


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)
