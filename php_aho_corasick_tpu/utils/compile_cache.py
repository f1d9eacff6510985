"""Location of JAX's persistent compilation cache for the entry points
(``chip_smoke.py``, ``bench.py``, ``benchmarks/bench_signatures.py``)."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(root: str) -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing is set here); otherwise point the cache at the
    fixed directory ``<root>/.jax_cache``.  Returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
