"""Build the package's CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with nvcc
for Hopper (``sm_90a``) into a shared library under the package's
``build/`` directory, named by a hash of the source and the flags, and
loaded with ctypes. With no CUDA device or no nvcc this raises: nothing
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "SOURCES", "build_all", "library_path", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")
#: every kernel source of the package, by name
SOURCES = ("resident_layered", "flooding", "compressed")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if _TOOLKIT_NVCC.exists():
        return str(_TOOLKIT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Path of the built ``csrc/<name>.cu`` library, building it first if
    needed. nvcc's report (registers, shared memory, spills) is kept
    beside it with the suffix ``.log``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA kernels cannot run here")
    nvcc = _nvcc()
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build_all(names=SOURCES) -> dict:
    """Builds the named sources at once, one nvcc each, all started
    together; returns {name: library path}."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(library_path, names)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    return ctypes.CDLL(str(library_path(name)))
