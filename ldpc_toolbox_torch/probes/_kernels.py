"""The probes' libraries and what their wrappers and ``main``s share."""

from __future__ import annotations

import ctypes
import functools
import statistics
import subprocess
import time
from typing import NamedTuple

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


class Chain(NamedTuple):
    """A chain of launches timed by ``chain_ms``."""

    #: the median of the launches' CUDA-event times, ms
    ms: float
    #: the median host time a launch took to enqueue (the call's own path,
    #: its two events included), ms
    host_ms: float
    #: the longest the device waited between one launch's end event and
    #: the next one's start event, ms: near 0 when the queue stayed ahead
    gap_ms: float


#: the calls ``chain_ms`` makes before its chain
WARM_UPS = 2
#: ``torch.cuda._sleep`` cycles a millisecond at the H100's top clock
#: (1.98 GHz); at a lower clock the sleep lasts longer
_CYCLES_PER_MS = 1_980_000


def chain_ms(fn, launches: int = 20) -> Chain:
    """Times ``launches`` calls of fn() as one chain, the host path out of
    the window: after ``WARM_UPS`` calls, a ``torch.cuda._sleep`` keeps the
    current stream busy for longer than the host takes to enqueue the
    chain (twice the last warm-up's host time a launch, and 1 ms more),
    each call between a start and an end event, one synchronize at the end;
    the median of the event pairs. Every probe kernel and library call is
    timed with it."""
    for _ in range(WARM_UPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(launches)]
    torch.cuda._sleep(int(min(2 * launches * host + 1.0, 500.0) * _CYCLES_PER_MS))
    hosts = []
    for start, end in pairs:
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        hosts.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    gaps = [end.elapsed_time(start) for (_, end), (start, _) in zip(pairs, pairs[1:])]
    return Chain(statistics.median(s.elapsed_time(e) for s, e in pairs),
                 statistics.median(hosts), max(gaps, default=0.0))


def turns(fns, launches: int = 20, rounds: int = 5) -> dict:
    """{name: Chain} of each fn in ``fns`` {name: fn}, timed by ``chain_ms``
    in turns (the order reversed every round): each field the median over
    ``rounds`` chains."""
    found = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            found[name].append(chain_ms(fns[name], launches))
    return {name: Chain(*(statistics.median(field) for field in zip(*chains)))
            for name, chains in found.items()}
