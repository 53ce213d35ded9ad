"""Persistent compilation cache location, shared by every entry point
(the CLI, chip_smoke.py, bench.py and the tools).

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
directory is set in code. Otherwise the cache lives at a fixed path,
<repo>/.jax_cache (listed in .gitignore): the path is part of the
cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def dir_to_set(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory the program must set itself: None when the
    environment already names one."""
    return None if environ.get(ENV_VAR) else DEFAULT_DIR


def enable_compile_cache() -> None:
    """Turn the persistent cache on, for every compile that takes at
    least a second."""
    import jax

    path = dir_to_set()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
