"""JAX's persistent compilation cache, in one place for every entry point.

The CLI, bench.py and chip_smoke.py call `enable_compile_cache()` before
their first compile. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it
itself and nothing is set here. Otherwise the cache lives at a fixed
directory inside the checkout (`<repo>/.jax_cache`, listed in .gitignore):
the path is part of what makes a later process find the entries again.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> Optional[Path]:
    """The directory to set, or None when the environment already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def enable_compile_cache() -> None:
    path = compile_cache_dir()
    if path is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(path))
