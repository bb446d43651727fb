"""Runtime setup: the persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other path. Otherwise the cache lives at a fixed
``<checkout>/.jax_cache/``: the path is part of the cache key, so a fixed one
lets later processes of the same checkout find what earlier ones compiled.
``ZOTPU_JAX_CACHE=off`` disables the cache (the test suite sets it: CPU
compiles are cheap, and concurrent cache writes from many test workers only
add risk).
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

_DONE = False


def cache_dir(environ=os.environ) -> str | None:
    """The cache directory this code must set, or None when it sets none
    (JAX_COMPILATION_CACHE_DIR is set, or the cache is off)."""
    if environ.get("ZOTPU_JAX_CACHE") == "off":
        return None
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE


def setup() -> None:
    """Configure the persistent compilation cache (idempotent)."""
    global _DONE
    if _DONE:
        return
    import jax
    if os.environ.get("ZOTPU_JAX_CACHE") == "off":
        jax.config.update("jax_enable_compilation_cache", False)
    else:
        path = cache_dir()
        if path is not None:
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
    _DONE = True
