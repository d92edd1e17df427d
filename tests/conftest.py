"""Test configuration.

Tests run on CPU with 8 virtual devices (the multi-device sharding tests
simulate a device mesh on them) and with x64 enabled — the reference test
suite is Float64 (``test/runtests.jl``); Float32 coverage is exercised
explicitly where the reference does.  The platform comes from
``JAX_PLATFORMS`` (CPU when unset) and is set through ``jax.config`` before
any backend is initialized.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them where JAX's first device is not a GPU.  On a GPU
host they run with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from landhydrology.constants import default_earth_param_set  # noqa: E402


@pytest.fixture
def param_set():
    return default_earth_param_set


@pytest.fixture
def gpu():
    """The first JAX device, skipping the test unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform!r}")
    return dev
