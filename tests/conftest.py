"""Test harness config.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices,
the standard JAX way to exercise shard_map/psum logic without a
multi-device machine. The Pallas kernel runs there in the interpreter.

Tests marked ``gpu`` need the card: they skip elsewhere, and
``python chip_smoke.py`` runs them compiled on the GPU, in its own
process. Whether a GPU is present is decided inside a fixture, never at
import or collection time, so every worker collects the same tests.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (the compiled Pallas kernel); skipped "
        "elsewhere — chip_smoke.py runs these on the card")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: the compiled kernel has no CPU backend")
