"""Persistent XLA compilation cache.

Compiling the fused kernel and the jitted wrappers around it takes seconds
per (kernel, shape) pair; JAX's persistent compilation cache makes every
process after the first pay only a disk read. Called by the command-line
entry points (bench.py, chip_smoke.py, scripts/, __graft_entry__.py);
library users opt in.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (and
then nothing else is set), otherwise ``<checkout>/.jax_cache``, a fixed path
inside the checkout (git-ignored).
"""
from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Idempotently point JAX at a persistent on-disk compilation cache and
    return the directory in use. Safe to call before or after JAX backend
    initialization."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        # JAX reads the variable itself; setting nothing keeps it in charge.
        return env_dir
    os.makedirs(_DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return _DEFAULT_DIR
