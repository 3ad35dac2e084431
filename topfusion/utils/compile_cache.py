"""Persistent XLA compile cache shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own default for the
cache directory, and nothing here overrides it.  Otherwise the cache lives
at a fixed path inside the checkout (``<repo>/.jax_cache``, listed in
``.gitignore``): the directory is part of what a later run must find, so
it is never derived from a temporary name, a process id or the time.

Call :func:`enable_compile_cache` before the process compiles anything;
JAX decides once, at its first compilation, whether a cache is in use.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``$JAX_COMPILATION_CACHE_DIR``
    or, when that is unset, at the checkout's ``.jax_cache``; return the
    directory in use."""
    path = os.environ.get(ENV_VAR)
    if not path:
        import jax

        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
