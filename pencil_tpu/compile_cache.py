"""Where JAX keeps compiled programs between runs.

A cold compile of the full MHD step takes tens of seconds; the persistent
compilation cache lets the next process load it instead.  The cache key
includes the directory, so the directory must not move between runs.
"""
from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache: next to the package, never a temporary name
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    ``JAX_COMPILATION_CACHE_DIR`` when that is set, else ``DEFAULT_DIR``."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
