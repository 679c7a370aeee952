"""JAX runtime configuration for the proving framework.

Enables the persistent compilation cache: the proof kernels (field conv
chains, 253-step scalar-mult scans) produce large XLA graphs whose first
compile is expensive; caching makes every later process start warm.
Importing any :mod:`bulletproofs_r1cs_gadgets_tpu.ops` module applies this.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and no other directory is set.  Otherwise the cache lives at the
fixed ``<repo>/.jax_cache`` (the path is part of the cache key, so it must
not move between processes).
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                 ".jax_cache")
)

_APPLIED = False


def cache_dir() -> str:
    """The directory this process compiles into."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def configure() -> None:
    global _APPLIED
    if _APPLIED:
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _APPLIED = True


configure()
