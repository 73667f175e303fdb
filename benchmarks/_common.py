"""Shared benchmark bootstrap: repo path + persistent compile cache.

Every benchmark script needs the same two things before touching JAX:
the repo root on sys.path (scripts are invoked as files, so only
``benchmarks/`` is auto-added) and the persistent compilation cache,
placed by :mod:`vaudio.utils.compile_cache` like every other entry point
(``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``).
Use it as:

    import _common
    _common.enable_compile_cache()
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from vaudio.utils.compile_cache import enable_compile_cache  # noqa: E402

__all__ = ["REPO", "enable_compile_cache"]
