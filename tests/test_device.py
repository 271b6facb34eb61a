"""utils.device: the GPU requirement and the compile-cache location."""

import jax
import pytest

from pydsproutines_tpu.utils import device


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch,
                                                      keep_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.setup_compile_cache()
    assert path == str(device.DEFAULT_CACHE_DIR)
    assert device.DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert (device.DEFAULT_CACHE_DIR.parent / "pyproject.toml").exists()
    assert jax.config.jax_compilation_cache_dir == path
    assert device.setup_compile_cache() == path      # stable across calls


def test_compile_cache_env_is_left_to_jax(monkeypatch, keep_cache_config,
                                          tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
