"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding paths can be
exercised without accelerator hardware, and with x64 enabled so float64/complex128
reference-parity tiers are available (the library itself is dtype-explicit).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0xD5B)


@pytest.fixture
def key():
    return jax.random.key(1234)


@pytest.fixture
def keep_cache_config():
    """Put JAX's compile-cache directory back after a test that sets it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)
