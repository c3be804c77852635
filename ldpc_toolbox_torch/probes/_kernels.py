"""The probes' libraries and what their wrappers and ``main``s share."""

from __future__ import annotations

import ctypes
import functools
import statistics
import subprocess

import torch

from ..ops import _build


def _bind(lib, fns):
    """Declares ``fns`` {name: (argtypes)} of a library, each returning a
    cudaError_t, and its error string; returns it."""
    for name, argtypes in fns.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.ldpc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bind(lib):
    """Declares the C interface of a library built from ``csrc/probes.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _bind(lib, {
        "ldpc_probe_stream": [p, p, ll, i, p],
        "ldpc_probe_alu_chain": [p, p] + [i] * 5 + [p],
        "ldpc_probe_rotated_gather": [p] * 4 + [i] * 9 + [p],
        "ldpc_probe_copy": [p, p, ll, p],
        "ldpc_probe_minsum": [p] * 4 + [i] * 6 + [p],
    })


def bind_layered(lib):
    """Declares the C interface of a library built from
    ``csrc/probe_layered.cu``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _bind(lib, {"ldpc_probe_layered_sweep": [p] * 5 + [i] * 8 + [f, f, i, i, p]})


@functools.cache
def lib():
    return bind(_build.load("probes"))


@functools.cache
def layered_lib():
    return bind_layered(_build.load("probe_layered"))


def raise_on(lib, err: int, name: str) -> None:
    """Raise if a launch's cudaError_t is not 0."""
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.ldpc_cuda_error_string(err).decode()}")


def on_card(name, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor of one device;
    returns that device's current stream (a pointer)."""
    dev = tensors[0].device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA device")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return torch.cuda.current_stream(dev).cuda_stream


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them; raises
    without a card: a probe measures the card or nothing."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes measure the card")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn() in milliseconds, after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
