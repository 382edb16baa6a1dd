"""JAX's persistent compilation cache, in one place for every entry point
(CLI, ``bench.py``, ``bench_suite.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it, so
    nothing is set in code. Otherwise the cache lives at ``<repo>/.jax_cache``
    — a fixed path, because the path is part of what a cache hit needs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
