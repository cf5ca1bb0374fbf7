"""Persistent XLA compilation cache shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and nothing
else is configured. Otherwise the cache lives at a fixed path inside the
checkout, ``<repo>/.jax_cache/`` (listed in ``.gitignore``): the path is
part of the cache key, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir(environ=None) -> str:
    """The directory the cache uses under ``environ`` (default os.environ)."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return that directory. Call before the first compile."""
    import jax

    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
