"""Test configuration: CPU with 8 virtual devices (sharding tests run the
same jitted step on an 8-device mesh and must equal the single-device
result), and x64 so the f64 oracle comparisons are exact.

``JAX_PLATFORMS`` picks the platform (default ``cpu``); tests marked
``gpu`` take the ``gpu`` fixture, which skips them unless JAX's default
device is a GPU (``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``).
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The default device, or a skip where it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev
