"""Builds the package's CUDA sources into shared libraries at first use.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (the
``csrc/*.cuh`` headers are shared).  ``nvcc`` compiles it for ``sm_90a`` into
``build/`` at the repository root (or ``$REPRO_TORCH_BUILD_DIR``), named after
a hash of the source, the headers and the flags so an edited source rebuilds,
and ``ctypes`` loads the result.  :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for them.  The compiler's output of a
successful build (``ptxas -v``: registers, shared memory and spills of every
kernel) is kept beside the library; :func:`build_log` returns it.  Nothing but
the sources in this package goes into a build.  A build or load failure raises
with the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "KERNEL_SOURCES", "build_dir", "build", "build_log", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"

# no --use_fast_math: the kernels keep IEEE inf/NaN semantics
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

KERNEL_SOURCES = {
    "schedule_dp": "schedule_dp.cu",
    "flash_attention": "flash_attention.cu",
    "rglru": "rglru.cu",
    "ssd": "ssd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "ssd_bwd": "ssd_bwd.cu",
    "moe_dispatch": "moe_dispatch.cu",
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
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> None:
    """Build the libraries of ``names`` (default: every kernel) that are not
    built yet: one ``nvcc`` process per source, all started together."""
    procs = []
    for name in (KERNEL_SOURCES if names is None else names):
        src, out = _target(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        procs.append((name, tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {KERNEL_SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))


def build_log(name: str) -> str:
    """The compiler's output of the build of kernel ``name`` (built first if
    need be)."""
    _, out = _target(name)
    if not out.exists():
        build([name])
    return out.with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    _, out = _target(name)
    if not out.exists():
        build([name])
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise RuntimeError(f"could not load {out}: {e}") from e
    _loaded[name] = lib
    return lib
