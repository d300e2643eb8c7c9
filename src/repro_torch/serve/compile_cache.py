"""Persistent build cache of the port's kernels.

The reference points JAX's persistent compilation cache at a directory so
compiled launches survive process restarts.  The port has no compiler cache
of that kind: what a warm pool builds is a captured CUDA graph per launch
shape, which lives in its process and is captured again in every process
(seconds per shape, ``Engine.warmup``'s ``compile_seconds``).  What does
persist is the ``nvcc`` build of every kernel (``kernels/_build``: one
shared library per source, named after a hash of the source and flags), so
this switch points the build directory at the given path.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compilation_cache"]


def enable_compilation_cache(path) -> bool:
    """Point the kernels' build directory (``REPRO_TORCH_BUILD_DIR``) at
    ``path`` (created if missing), so a later process on the same path
    loads the ``nvcc`` builds instead of compiling them.  Only the builds
    persist: a launch is captured again in every process.  A library that
    this process has already loaded stays loaded from where it was built.
    Returns ``True``."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(p)
    return True
