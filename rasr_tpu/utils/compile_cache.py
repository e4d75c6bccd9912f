"""JAX persistent compilation cache location, one rule for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and JAX reads it
itself, so nothing is configured. Otherwise the cache is ``.jax_cache`` at
the repository root: a fixed path, because the path is part of the cache
key and a directory that moves between runs never hits.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory the program uses under ``environ``."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; returns it.

    Call before the first compile."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
