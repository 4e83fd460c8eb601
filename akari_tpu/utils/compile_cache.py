"""Where the persistent XLA compile cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the entry points (the render CLI, bench.py,
chip_smoke.py) point JAX at ``.jax_cache/`` in the checkout: a fixed path,
since the path is part of the cache key, so a directory that moved would
never hit. The directory is git-ignored.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def compile_cache_dir(environ=None):
    """The cache directory the rule above picks for ``environ``."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache():
    """Apply the rule to this process; returns the directory in use."""
    path = compile_cache_dir()
    if path == DEFAULT_DIR:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
