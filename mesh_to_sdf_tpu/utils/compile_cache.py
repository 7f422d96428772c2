"""Persistent compilation cache location for the CLI, bench and smoke runs.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives at a fixed ``<checkout>/.jax_cache``
(listed in ``.gitignore``): the path is part of the cache key, so a fixed
directory is what lets a later process find earlier compilations.
"""
from __future__ import annotations

import os

#: Root of the checkout holding the package.
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def configure_compile_cache():
    """Point JAX's compilation cache at ``<checkout>/.jax_cache`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set. Returns the directory set, or
    None when the environment decides."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
