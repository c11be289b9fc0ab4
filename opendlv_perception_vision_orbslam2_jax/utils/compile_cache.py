"""Persistent XLA compilation cache for the entry points.

A warm start is dominated by compiles; the persistent cache turns them into
disk loads.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module sets nothing.  Otherwise the cache lives at a fixed
``.jax_cache`` directory in the checkout: a fixed path, because the path is
part of what makes a later run find the entries again.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir_for(platform: str, environ=os.environ) -> str | None:
    """The directory to configure for a backend ``platform``, or None to
    leave JAX's setting alone: when ``JAX_COMPILATION_CACHE_DIR`` is set, and
    on the CPU, whose cached executables are not portable across machine
    types."""
    if environ.get("JAX_COMPILATION_CACHE_DIR") or platform == "cpu":
        return None
    return REPO_CACHE_DIR


def enable_compile_cache() -> str | None:
    """Point JAX's persistent cache at :func:`cache_dir_for` the default
    backend.  Returns the directory set, or None."""
    import jax

    cache_dir = cache_dir_for(jax.default_backend())
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
