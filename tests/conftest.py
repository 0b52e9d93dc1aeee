"""Test configuration.

By default everything runs on the CPU with 8 virtual devices, so the
sharding/collective paths are exercised without GPUs (SURVEY.md §4.4).
Tests marked ``gpu`` need an NVIDIA GPU and skip without one (the
``gpu`` fixture decides at run time). On a machine with a GPU run them
with

    python -m pytest -m gpu tests/

which keeps JAX on the GPU: selecting the ``gpu`` marker turns the CPU
forcing below off.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    if (config.getoption("markexpr") or "").strip() != "gpu":
        import jax

        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest -m gpu tests/` "
                    "on a machine with one")
