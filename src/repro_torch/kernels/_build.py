"""Builds the package's CUDA sources into shared libraries at first use.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` into ``build/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``), named after a hash of the source and the flags
so an edited source rebuilds, and ``ctypes`` loads the result.  Nothing but
the sources in this package goes into a build.  A build or load failure
raises with the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "KERNEL_SOURCES", "build_dir", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"

# no --use_fast_math: the kernels keep IEEE inf/NaN semantics
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

KERNEL_SOURCES = {
    "schedule_dp": "schedule_dp.cu",
}

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built on this machine")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / KERNEL_SOURCES[name]
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src, out = _target(name)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {KERNEL_SOURCES[name]} (exit {proc.returncode}):\n"
                f"{proc.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise RuntimeError(f"could not load {out}: {e}") from e
    _loaded[name] = lib
    return lib
