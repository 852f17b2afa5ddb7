"""Process-level JAX set-up shared by the CLI, bench.py and chip_smoke.py.

One rule for the persistent compilation cache: when the
JAX_COMPILATION_CACHE_DIR environment variable is set, JAX reads it
itself and nothing here touches the cache; otherwise the cache goes to
one fixed directory inside the checkout (`.jax_cache`, listed in
.gitignore).  A fixed path matters: the directory is part of the cache
key, so a path that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CACHE_ENV", "DEFAULT_CACHE_DIR", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(jax) -> str:
    """Turn on the persistent compilation cache; returns its directory.
    Call before the first compilation."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return str(DEFAULT_CACHE_DIR)
