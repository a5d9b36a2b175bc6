"""Persistent XLA compile cache at one fixed place.

Entry points (the CLI, bench.py, chip_smoke.py) call ``enable_compile_cache``
before their first compile. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing here overrides it; otherwise the cache lives in
``<repo>/.jax_cache`` (listed in .gitignore). The path is fixed because it is
part of the cache key: a directory that moves never hits.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
