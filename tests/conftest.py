"""Test config: a deterministic 8-device CPU backend, unless the card is asked for.

The suite runs on the CPU with ``JAX_PLATFORMS=cpu``: device-kernel
correctness is asserted against the host oracles there, Pallas kernels in
interpret mode. Tests marked ``gpu`` need the card and skip elsewhere; run
them on the GPU with ``RAISIN_TEST_GPU=1 python -m pytest tests -m gpu``,
which leaves the platform to JAX.
"""

import os
import sys

import pytest

if not os.environ.get("RAISIN_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: run with RAISIN_TEST_GPU=1 on the card")
