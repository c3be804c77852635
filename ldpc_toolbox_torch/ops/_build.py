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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "SOURCES", "build_all", "compile_source", "library_path", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")
#: every kernel source of the package, by name (the int8 and float-rule
#: instances of the message kernels and of the flooding phases in sources
#: of their own, the float-rule ones one a precision, and the streaming
#: layered sweep's apart from the resident layered kernel's, so that the
#: parallel build keeps its length)
SOURCES = ("resident_layered", "flooding", "compressed", "resident_layered_i8",
           "flooding_i8", "resident_layered_f32", "resident_layered_f64",
           "flooding_f32", "flooding_f64", "fused_layered", "fused_layered_i8",
           "fused_layered_f32", "fused_layered_f64")


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
    so.with_suffix(".log").write_text(compile_source(src, tmp, nvcc))
    os.replace(tmp, so)
    return so


def compile_source(src: Path, out: Path, nvcc: str | None = None) -> str:
    """nvcc with the package's flags, ``src`` (a ``.cu`` that may include
    the headers beside it) into the shared library ``out``; returns nvcc's
    report (registers, shared memory, spills)."""
    proc = subprocess.run(
        [nvcc or _nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_all(names=SOURCES) -> dict:
    """Builds the named sources at once, one nvcc each, all started
    together; returns {name: (library path, seconds until it was ready)}."""
    t0 = time.perf_counter()

    def timed(name):
        path = library_path(name)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    return ctypes.CDLL(str(library_path(name)))
