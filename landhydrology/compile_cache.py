"""Where JAX's persistent compilation cache lives.

One function decides it for the CLI, the benchmarks, the experiments and
``chip_smoke.py``: repeated runs of the same configuration then skip XLA
compilation.  The directory is part of what makes a cache hit, so it is
fixed rather than derived from the home or temporary directory.
"""

from __future__ import annotations

import os

#: used when ``JAX_COMPILATION_CACHE_DIR`` is unset: a directory at the root
#: of the checkout, listed in ``.gitignore``
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_compile_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    function sets nothing; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
