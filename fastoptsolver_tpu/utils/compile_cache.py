"""The one rule for where JAX's persistent compilation cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache goes to a fixed
directory inside the checkout (``.jax_cache/``, listed in ``.gitignore``):
the path is part of the cache key, so a directory that moves between runs
(a temporary directory, a PID, a timestamp) would never hit.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Apply the rule to this process (call before the first compile) and
    return the directory in use. Every program is cached, however quick its
    compile: a run that compiles once per process is what the cache is for."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = str(CHECKOUT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
