"""Where JAX keeps its persistent compilation cache.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
changes it.  Otherwise the cache goes to one fixed directory of the checkout,
`<checkout>/.jax_cache` (listed in .gitignore): the directory is part of the
cache key, so a path that moved between runs would never hit.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """The directory the cache lands in under `environ`."""
    return environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def init_compile_cache(environ: Optional[Mapping[str, str]] = None) -> str:
    """Point JAX at `cache_dir()` unless the environment already does;
    returns the directory.  Call before the first compilation."""
    environ = os.environ if environ is None else environ
    if not environ.get(ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", cache_dir(environ))
    return cache_dir(environ)
