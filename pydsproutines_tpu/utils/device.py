"""The device a measurement runs on, and where compiled programs are kept.

Entry points that time or check the program on the accelerator call both
helpers first: ``setup_compile_cache()`` before anything compiles, then
``require_gpu()``, which refuses to carry on when JAX found no GPU.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

# <checkout>/.jax_cache: one fixed path, so a later run finds what an earlier
# one compiled (the path is part of the cache key)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of the devices JAX runs on; raises
    RuntimeError unless they are GPUs."""
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {dev.platform} ({dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    it. ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX itself;
    otherwise the cache lives at ``DEFAULT_CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def card_power_limits() -> str:
    """``name, power.limit`` of each GPU as nvidia-smi reports them, one
    line per card (a subprocess: the caller's JAX is not involved)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
