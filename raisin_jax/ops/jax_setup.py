"""Process-wide JAX configuration for the device kernels.

Enables the persistent compilation cache so the scan state machines and
kernels, whose compiles take tens of seconds, compile once per checkout
rather than once per process. ``JAX_COMPILATION_CACHE_DIR``, when set, names
the cache and JAX reads it itself; otherwise the cache is ``.jax_cache/`` at
the root of the checkout (git-ignored). Imported for effect by every module
in raisin_jax.ops.
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(_REPO, ".jax_cache")

_initialized = False


def ensure() -> None:
    global _initialized
    if _initialized:
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _initialized = True


ensure()
