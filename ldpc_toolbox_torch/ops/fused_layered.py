"""One horizontal-layered sweep of frame tiles: the streaming layered form.

``fused_layered_iteration`` ports the JAX package's
``ops/fused_layered.py fused_layered_iteration``: ``(qv, rcv) -> (qv',
rcv', bits)`` over ``(nbt, *, Z, Bt)`` tiles, one sweep over all check
groups in bucket-major order (the sweep of ``resident_layered_decode``),
then the posterior hard bits ``qv' <= 0``. Unlike the JAX function, whose
arrays are immutable, it updates ``qv`` and ``rcv`` **in place** and
returns them: the streaming decode
(``decoder/lifted_layered.streaming_layered_decode``) carries them from
one sweep to the next.

Qv and Rcv take the rule's types, as in the resident layered decode
(``resident_layered.posterior_dtype``): min-sum f32 Qv and f32 or bf16
Rcv; the i8 rules int16 Qv and int8 Rcv; the float rules both in their
storage type, f32 or f64.

On a CUDA tensor it launches ``fused_layered_kernel`` of
``csrc/streaming.cuh`` (one thread block per tile of 4 frames, a thread
per lane: the resident layered kernel's sweep, one iteration a launch) on
the rule's family: min-sum from ``csrc/fused_layered.cu``, the i8 rules
from ``csrc/fused_layered_i8.cu`` (``fused_layered_iteration_i8``), the
float rules from ``csrc/fused_layered_f32.cu`` and ``_f64.cu``
(``fused_layered_iteration_float``), each family counting its launches
apart; or it raises. On a CPU tensor it runs the plain version
``fused_layered_iteration_reference``, which updates in place too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fused_bp2 import _MSG_DTYPES, is_float_rule, is_i8
from .resident_layered import (
    LANE_THREADS,
    layered_launch,
    message_sweep,
    plane_tables,
    raise_on,
)

__all__ = [
    "fused_layered_iteration",
    "fused_layered_iteration_float",
    "fused_layered_iteration_i8",
    "fused_layered_iteration_reference",
]

#: the sources of the float-rule instances, by storage type
FLOAT_SOURCES = {torch.float32: "fused_layered_f32", torch.float64: "fused_layered_f64"}


def _bind(lib, fn, rule_args):
    """Declares the C interface of the sweep ``fn`` of a library: four
    pointers, the table array, nbt, CG, E, VG, Z, Bt, max degree, threads,
    then ``rule_args`` and the stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    getattr(lib, fn).argtypes = [p] * 5 + [i] * 8 + rule_args + [p]
    getattr(lib, fn).restype = i
    lib.ldpc_cuda_error_string.argtypes = [i]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bind(lib):
    """Declares the C interface of a library built from
    ``csrc/fused_layered.cu`` (big, scale, msg_bf16); returns it."""
    f, i = ctypes.c_float, ctypes.c_int
    return _bind(lib, "ldpc_fused_layered_iteration", [f, f, i])


def bind_i8(lib):
    """Declares the C interface of a library built from
    ``csrc/fused_layered_i8.cu`` (rule kind, flags); returns it."""
    return _bind(lib, "ldpc_fused_layered_iteration_i8", [ctypes.c_int] * 2)


def bind_float(lib):
    """Declares the C interface of a library built from
    ``csrc/fused_layered_f32.cu`` or ``_f64.cu`` (rule kind, big, clamp,
    prod_max); returns it."""
    return _bind(lib, "ldpc_fused_layered_iteration_float",
                 [ctypes.c_int] + [ctypes.c_double] * 3)


@functools.cache
def _lib():
    return bind(_build.load("fused_layered"))


@functools.cache
def _lib_i8():
    return bind_i8(_build.load("fused_layered_i8"))


@functools.cache
def _lib_float(name):
    return bind_float(_build.load(name))


def _sweep_args(qv_t, rcv_t, layout, rule):
    """The checks of a sweep launch; returns (bits, the launch's leading
    arguments: the four pointers, the tables and the dims)."""
    tables, dims, park, stream = layered_launch(qv_t, layout, rule)
    nbt, VG, Z, Bt = qv_t.shape
    if (
        rcv_t.shape != (nbt, layout.E, Z, Bt)
        or rcv_t.dtype != rule.storage_dtype
        or rcv_t.device != qv_t.device
        or not rcv_t.is_contiguous()
    ):
        raise ValueError(
            f"rcv_t must be contiguous (nbt, {layout.E}, {Z}, {Bt}) "
            f"{rule.storage_dtype} on qv_t's device"
        )
    bits = torch.empty(qv_t.shape, dtype=torch.int8, device=qv_t.device)
    head = (qv_t.data_ptr(), rcv_t.data_ptr(), bits.data_ptr(),
            None if park is None else park.data_ptr(), tables, *dims, LANE_THREADS)
    return bits, head, stream


def fused_layered_iteration(qv_t, rcv_t, layout, rule):
    """One layered sweep in place: qv_t (nbt, VG, Z, Bt) posteriors (f32;
    int16 for an i8 rule, the storage type for a float rule) and rcv_t
    (nbt, E, Z, Bt) messages in the rule's storage type, both updated;
    returns (qv_t, rcv_t, bits (nbt, VG, Z, Bt) int8). On a CUDA tensor an
    i8 rule goes to ``fused_layered_iteration_i8``, a float rule to
    ``fused_layered_iteration_float``."""
    if qv_t.device.type == "cpu":
        return fused_layered_iteration_reference(qv_t, rcv_t, layout, rule)
    if is_i8(rule):
        return fused_layered_iteration_i8(qv_t, rcv_t, layout, rule)
    if is_float_rule(rule):
        return fused_layered_iteration_float(qv_t, rcv_t, layout, rule)
    bits, head, stream = _sweep_args(qv_t, rcv_t, layout, rule)
    lib = _lib()
    err = lib.ldpc_fused_layered_iteration(
        *head, rule.big, rule.scale, _MSG_DTYPES[rule.storage_dtype], stream
    )
    raise_on(lib, err, "fused_layered_iteration")
    fused_layered_iteration.launches += 1
    return qv_t, rcv_t, bits


def fused_layered_iteration_i8(qv_t, rcv_t, layout, rule):
    """``fused_layered_iteration`` for an i8 rule, through the int8
    instances (int16 Qv, int8 Rcv, int32 arithmetic); check degree at most
    ``I8_MAX_CHECK_DEGREE``."""
    if qv_t.device.type == "cpu":
        return fused_layered_iteration_reference(qv_t, rcv_t, layout, rule)
    if not is_i8(rule):
        raise TypeError(f"{type(rule).__name__} is not an i8 rule")
    bits, head, stream = _sweep_args(qv_t, rcv_t, layout, rule)
    lib = _lib_i8()
    err = lib.ldpc_fused_layered_iteration_i8(*head, rule.kind, rule.flags, stream)
    raise_on(lib, err, "fused_layered_iteration_i8")
    fused_layered_iteration_i8.launches += 1
    return qv_t, rcv_t, bits


def fused_layered_iteration_float(qv_t, rcv_t, layout, rule):
    """``fused_layered_iteration`` for a float rule, through the float-rule
    instances (Qv, Rcv and arithmetic in the storage type, f32 or f64);
    check degree at most ``rule.max_check_degree``."""
    if qv_t.device.type == "cpu":
        return fused_layered_iteration_reference(qv_t, rcv_t, layout, rule)
    if not is_float_rule(rule):
        raise TypeError(f"{type(rule).__name__} is not a float rule")
    bits, head, stream = _sweep_args(qv_t, rcv_t, layout, rule)
    lib = _lib_float(FLOAT_SOURCES[rule.storage_dtype])
    err = lib.ldpc_fused_layered_iteration_float(
        *head, rule.kind, rule.big, rule.clamp, rule.prod_max, stream
    )
    raise_on(lib, err, "fused_layered_iteration_float")
    fused_layered_iteration_float.launches += 1
    return qv_t, rcv_t, bits


#: kernel launches since the count was last set to 0 (the min-sum
#: instances; the int8 and float-rule instances count on their wrappers)
fused_layered_iteration.launches = 0
fused_layered_iteration_i8.launches = 0
fused_layered_iteration_float.launches = 0


def fused_layered_iteration_reference(qv_t, rcv_t, layout, rule):
    """The plain PyTorch version of ``fused_layered_iteration``, on any
    device, same arguments and results (in place)."""
    nbt, VG, Z, Bt = qv_t.shape
    N = nbt * Bt

    def untile(x):  # a copy, written back below
        x = x.permute(1, 2, 0, 3).clone(memory_format=torch.contiguous_format)
        return x.reshape(x.shape[0] * Z, N)

    qv = untile(qv_t)
    rcv = untile(rcv_t).reshape(layout.E, Z, N)
    message_sweep(qv, rcv, layout, rule, plane_tables(layout, qv_t.device))
    qv_t.copy_(qv.reshape(VG, Z, nbt, Bt).permute(2, 0, 1, 3))
    rcv_t.copy_(rcv.reshape(layout.E, Z, nbt, Bt).permute(2, 0, 1, 3))
    return qv_t, rcv_t, (qv_t <= 0).to(torch.int8)
