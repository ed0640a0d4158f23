"""Persistent XLA compilation cache.

Heavy render configs take long to compile; with the cache, a config that
has compiled once reloads in seconds.  The cache lives where
JAX_COMPILATION_CACHE_DIR says, or else in <repo>/.jax_cache (a fixed
path: the path is part of the cache key).  Call enable() before the first
compilation.  The library itself stays side-effect-free: only entry
points (CLI, bench.py, chip_smoke.py, scripts/) opt in.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable(cache_dir: str | None = None) -> str:
    import jax
    d = cache_dir or os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(_REPO_ROOT, ".jax_cache"))
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d
