"""JAX's persistent compilation cache at a fixed place.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here. Otherwise the cache goes to `.jax_cache` at the root of the
checkout (listed in .gitignore): a fixed path, because the path is part
of the cache key and a cache that moves never hits.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = os.environ.get(ENV)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
