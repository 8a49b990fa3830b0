"""Persistent compile cache for the repository's scripts.

The library itself sets no cache. Scripts (``chip_smoke.py``, the bench
scripts, ``__graft_entry__.py``) call `enable_compile_cache` once, before
their first compilation:

* when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
  directory and nothing else is set;
* otherwise the cache goes to ``<checkout>/.jax_cache`` (git-ignored), a
  fixed path — the path is part of the cache key, so a directory that
  moved between runs would never hit.
"""

from __future__ import annotations

import os

import jax

__all__ = ["CACHE_ENV", "default_cache_dir", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the directory above the package."""
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(package), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
