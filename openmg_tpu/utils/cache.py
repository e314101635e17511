"""Where JAX keeps its persistent compilation cache.

Compiling the solve programs takes seconds to minutes at benchmark sizes,
so the launchers (``chip_smoke.py``, ``bench.py``, ``python -m
openmg_tpu``) keep compiled programs across processes.  The cache's path
is part of its key: it is either the directory ``JAX_COMPILATION_CACHE_DIR``
names or the fixed ``.jax_cache`` at the root of the checkout, never a
temporary, per-process or time-stamped name.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["use_compile_cache", "CHECKOUT_ROOT"]

CHECKOUT_ROOT = Path(__file__).resolve().parents[2]


def use_compile_cache(root: str | os.PathLike | None = None) -> str:
    """Enable the persistent compilation cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it, and no
    other directory is set here.  Otherwise the cache goes to
    ``<root>/.jax_cache`` (``root`` defaults to the checkout).  Call before
    the first compilation: JAX decides once per process whether a cache
    is in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(Path(root if root is not None else CHECKOUT_ROOT) / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
