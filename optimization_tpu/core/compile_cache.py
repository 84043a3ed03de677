"""Where JAX's persistent compilation cache lives.

Compiling the solvers is a large share of a cold run (the certified pose
solve compiles many nested while-loop programs), and the on-disk cache is
what lets a second process skip it.  Entry points call
:func:`enable_compile_cache` once, before their first compile.
"""

from __future__ import annotations

import os

import jax

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

# A fixed path inside the checkout: the cache directory is part of what a
# lookup matches, so a temporary or per-process name would never hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and it is
    left alone; otherwise the cache goes to :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
