"""Where compiled programs are cached between processes.

One rule for every entry point (``cli.main``, ``bench.py``,
``chip_smoke.py``):

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set
  here, so entries land only there.
- unset, on a GPU: ``<checkout>/.jax_cache`` (git-ignored).  A fixed path,
  because the path is part of the cache key: a directory that moves never
  hits.
- unset, on any other backend: no cache.  XLA:CPU entries encode the host's
  exact CPU features and can fault when reloaded on another host, and they
  would bloat the checkout.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["CACHE_DIR", "configure_compile_cache"]

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache")


def configure_compile_cache(platform: Optional[str] = None) -> Optional[str]:
    """Apply the rule above; returns the directory in use, or None.

    ``platform`` defaults to ``jax.default_backend()``, which initialises
    the backends: call this after ``jax.distributed.initialize``.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    if platform is None:
        platform = jax.default_backend()
    if platform != "gpu":
        return None
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
