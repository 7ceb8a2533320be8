"""Where JAX keeps its persistent compilation cache — one place for every
entry point (cli.main, bench.py, chip_smoke.py, tools/)."""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Use $JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself,
    so nothing else is set); otherwise the fixed <repo>/.jax_cache. The
    path is part of the cache key, so it is never temporary. -> the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
