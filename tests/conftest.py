"""Test config: the CPU backend with 8 virtual devices, so multi-device
sharding tests run anywhere (the JAX idiom for meshes without hardware).
JAX_PLATFORMS set by the caller wins: the GPU lane runs with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_parity.py`."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (see README)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def gpu():
    """The first device when it is a GPU; skips otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; the backend here is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def oracle():
    """The reference binary as a parity oracle; skips if unavailable."""
    from tests.oracle.build_oracle import build_oracle, run_oracle

    if build_oracle() is None:
        pytest.skip("reference sources not available")
    return run_oracle
