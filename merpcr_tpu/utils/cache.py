"""Persistent XLA compilation cache placement.

The scan pipeline compiles one program per (parameters, table shape, tile
length) combination; caching compiled artifacts on disk makes repeat CLI
runs and test sessions start fast. The directory is never derived from a
temp name, a pid or the time, so the next process finds it again:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this module
  sets no other directory;
* otherwise one fixed directory inside the checkout (``<repo>/.jax_cache``,
  listed in ``.gitignore``).

The engine's persisted rescan-capacity seeds (``rescan_seeds.json``) live
in the same directory. ``MERPCR_TPU_CACHE=0`` disables both.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_ENABLED = False


def cache_dir() -> str | None:
    """Directory for compiled programs and rescan seeds; None when
    ``MERPCR_TPU_CACHE=0`` disables persistence."""
    if os.environ.get("MERPCR_TPU_CACHE", "1") == "0":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache() -> None:
    # Note for long many-compilation processes: each loaded executable
    # mmaps ~9+ regions, and a process that compiles or deserializes
    # thousands of programs can cross the kernel's vm.max_map_count, which
    # jaxlib 0.9.0 does not survive gracefully — call jax.clear_caches()
    # periodically (see tests/conftest.py).
    global _ENABLED
    if _ENABLED:
        return
    _ENABLED = True
    import jax

    d = cache_dir()
    if d is None:
        jax.config.update("jax_enable_compilation_cache", False)
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
