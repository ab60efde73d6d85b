"""Where compiled programs persist between processes.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, that
directory is the cache and nothing here overrides it. Otherwise the entry
points (the CLI, ``bench.py``, ``chip_smoke.py``) keep the cache in
``<repo>/.jax_cache`` — a fixed path, since the path is part of what makes
a later process find the entries again.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the persistent compile cache lives in."""
    return os.environ.get(ENV) or str(REPO_CACHE)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return cache_dir()
