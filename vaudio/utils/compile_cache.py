"""Where every entry point keeps JAX's persistent compilation cache.

One rule for the CLI, ``bench.py``, ``chip_smoke.py``, the benchmark
scripts and the doctor: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here; otherwise the cache lives at
the fixed ``<checkout>/.jax_cache`` (listed in ``.gitignore``).  The
path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX at :func:`compile_cache_dir` and return it.

    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX picks
    the variable up on its own).  Call before the first compilation.
    """
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
