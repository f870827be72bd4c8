"""The accelerator the program runs on, and where it keeps compiled code.

``gpu_backend()`` is the one capability test: code that needs a CUDA card
(compiled GPU kernels, the on-card test tier, measurements) asks it and
nothing else. Everything else is plain JAX and runs on any backend.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache: a fixed path, so every process of this checkout
# finds what an earlier one compiled (the path is part of the cache key)
_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def gpu_backend() -> bool:
    """True when JAX's default backend is a CUDA GPU."""
    return jax.default_backend() == "gpu"


def require_gpu() -> jax.Device:
    """The first device, or RuntimeError when it is not a GPU: measurement
    entry points refuse to fall back to the CPU."""
    dev = jax.devices()[0]
    if not gpu_backend():
        raise RuntimeError(
            f"this program measures the GPU, but JAX's first device is "
            f"{dev.platform!r} ({dev.device_kind})")
    return dev


def enable_compile_cache() -> None:
    """Keep JAX's persistent compilation cache where
    JAX_COMPILATION_CACHE_DIR says (JAX reads that variable itself), or
    else in <checkout>/.jax_cache. Call before the first compilation."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", str(_CACHE_DIR))
