"""Persistent XLA compilation cache.

The full system compiles a few dozen distinct jitted programs. Persisting
the compiled executables to disk lets every run after the first skip that
work. The cache lives in `JAX_COMPILATION_CACHE_DIR` when it is set, and
otherwise at the fixed `<checkout>/.jax_cache` (the path is part of the
cache key, so it must not move). Call early, before the first jit trace.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str:
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
