"""Persistent compilation cache: one place decides where compiled programs
are kept, for the engine, the CLI, bench.py and chip_smoke.py."""

from __future__ import annotations

import os
from pathlib import Path

# the fixed in-checkout default (listed in .gitignore); the path is part of
# the cache key, so it must not move between runs
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_done = False


def enable_compile_cache() -> None:
    """Persistent cache in JAX_COMPILATION_CACHE_DIR when set (JAX reads it
    itself; no directory is set here), else in the checkout's `.jax_cache`."""
    global _done
    if _done:
        return
    _done = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
