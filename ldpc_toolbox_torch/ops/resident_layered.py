"""Whole horizontal-layered decode of frame tiles.

``resident_layered_decode`` keeps the contract of
``ldpc_toolbox_tpu.ops.resident_layered.resident_layered_decode``: it takes
a batch cut into tiles of Bt frames, ``(nbt, VG, Z, Bt)`` planes, runs all
iterations (layered sweep, syndrome test, per-frame freeze at first
convergence, per-tile early exit) and returns the hard bits, iteration
counts and convergence flags. On a CUDA tensor it launches the hand-written
kernel of ``csrc/resident_layered.cu`` (one thread block per tile of 4
frames, a thread per lane) or raises, also for a tile of another width; on
a CPU tensor it runs the plain version ``resident_layered_decode_reference``
(any width).

Semantics (bit-identical to the JAX package's kernel and jnp path): layers
are the check groups in bucket-major order; every x of a group is formed
from the layer-entry Qv; the group's deltas ``Rnew - Rold`` (Rnew in f32,
Rold as loaded from its storage type) are then added to Qv in edge order,
one rounding per addition, so two edges of one group into the same
variable group give ``(Qv + d1) + d2``. Iteration 0 tests the raw-channel
hard bits, so a frame can finish with 0 iterations; a frame that never
converges keeps the raw-channel bits if no iteration ran.

The i8 rules (``MinstarApproxI8Rule``, ``AminstarI8Rule``) keep Qv in
int16 and Rcv in int8 and compute in int32: ``x = clip(Qv - Rold, +-127)``
(127 at the missing lane), Rnew from the rule, ``Qv += Rnew - Rold`` in
int16 without saturation, as the JAX package does. On a CUDA tensor
``resident_layered_decode`` passes them to ``resident_layered_decode_i8``,
the wrapper of the kernel's int8 instances (``csrc/resident_layered_i8.cu``,
check degree at most ``I8_MAX_CHECK_DEGREE``, ``I8_LAYERED_THREADS`` a
block), which counts their launches apart from the min-sum instances'.

The float rules (``PhiRule``, ``TanhRule``, ``MinstarApproxRule``,
``AminstarRule``) keep Qv and Rcv in their storage type, f32 or f64, and
compute in it: ``x = Qv - Rold`` (big, the type's largest value, at the
missing lane), Rnew from the rule, ``Qv += Rnew - Rold`` in edge order. On
a CUDA tensor ``resident_layered_decode`` passes them to
``resident_layered_decode_float``, the wrapper of the kernel's float-rule
instances (``csrc/resident_layered_f32.cu`` and ``_f64.cu``; check degree
at most the rule's ``max_check_degree``: 64, 32 for MinstarApprox), which
counts their launches apart. The f32 instances' check lanes give a thread
a frame pair of a lane (``csrc/float_rules.cuh`` FloatRule's
LayeredUnits), at ``LANE_THREADS`` a block as every other instance.

The layered kernels (this one, ``ops/resident_compressed.py``'s and
``ops/fused_layered.py``'s) share the launch checks of this module. The
kernels that give a thread one lane of a tile's four frames and copy the
layout tables into shared memory (``shared_ints``) share ``lane_launch``:
this one, the two compressed ones, ``ops/resident_flooding.py``'s and the
streaming sweep. A layered check group that reaches a variable
group twice parks its deltas between the check update and the posterior
update: after the tables when ``max_chk_degree * Z * 4`` floats fit there
too, in a device-memory scratch otherwise (CCSDS C2: 261,632 bytes; the
f64 instances park 8-byte deltas). The
streaming sweep (``ops/fused_layered.py``) is the same lane code one
iteration a launch (``layered_launch``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fused_bp2 import (
    _MSG_DTYPES,
    BT,
    I8_MAX_CHECK_DEGREE,
    check_degree_cap,
    is_float_rule,
    is_i8,
    takes_storage,
)

__all__ = [
    "BT",
    "I8_MAX_CHECK_DEGREE",
    "I8_LAYERED_THREADS",
    "LANE_THREADS",
    "LAYERED_TABLES",
    "lane_launch",
    "resident_layered_decode",
    "resident_layered_decode_float",
    "resident_layered_decode_i8",
    "resident_layered_decode_reference",
    "layered_decode_planes",
    "layered_loop",
    "message_sweep",
    "park_dtype",
    "parks_in_device_memory",
    "posterior_dtype",
    "plane_tables",
    "shared_ints",
]

#: threads per block of the kernels with a thread per lane of a tile's 4
#: frames (the most ``csrc/lanes.cuh`` builds them for)
LANE_THREADS = 256
#: threads per block of the i8 rules' resident layered kernel
#: (``csrc/i8.cuh`` I8Rule's LayeredUnits: a lane's four frames a thread, a
#: flagship check group of 360 lanes in one pass)
I8_LAYERED_THREADS = 384
#: shared-memory ints of their decode-loop control words
_CONTROL_INTS = 8
#: dynamic shared memory a block may use on Hopper
MAX_SHARED_BYTES = 232_448

#: the layout tables the layered and compressed kernels read, in the order
#: of ``Tables`` in ``csrc/layered.cuh``
LAYERED_TABLES = (
    "chk_cs", "syn_vg", "syn_rot", "chk_rot", "syn_mask", "var_cs",
    "rec_plane", "rec_group", "rec_slot", "rec_rot",
)


@functools.cache
def _lib():
    return bind(_build.load("resident_layered"))


def bind(lib):
    """Declares the C interface of a library built from
    ``csrc/resident_layered.cu``; returns it."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i] * 7  # nbt, CG, E, VG, Z, Bt, max degree
    lib.ldpc_resident_layered_decode.argtypes = (
        [p] * 7 + dims + [i, i, f, f, i, p]
    )
    lib.ldpc_resident_layered_decode.restype = i
    lib.ldpc_cuda_error_string.argtypes = [i]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_i8():
    return bind_i8(_build.load("resident_layered_i8"))


def bind_i8(lib):
    """Declares the C interface of a library built from
    ``csrc/resident_layered_i8.cu``; returns it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # pointers, nbt, CG, E, VG, Z, Bt, max degree, iterations, threads,
    # rule kind, flags, stream
    lib.ldpc_resident_layered_i8_decode.argtypes = [p] * 7 + [i] * 11 + [p]
    lib.ldpc_resident_layered_i8_decode.restype = i
    lib.ldpc_cuda_error_string.argtypes = [i]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
    return lib


#: the sources of the float-rule instances, by storage type
FLOAT_SOURCES = {torch.float32: "resident_layered_f32", torch.float64: "resident_layered_f64"}


@functools.cache
def _lib_float(name):
    return bind_float(_build.load(name))


def bind_float(lib):
    """Declares the C interface of a library built from
    ``csrc/resident_layered_f32.cu`` or ``_f64.cu``; returns it."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    # pointers, nbt, CG, E, VG, Z, Bt, max degree, iterations, threads,
    # rule kind, big, clamp, prod_max, stream
    lib.ldpc_resident_layered_float_decode.argtypes = [p] * 7 + [i] * 10 + [d] * 3 + [p]
    lib.ldpc_resident_layered_float_decode.restype = i
    lib.ldpc_cuda_error_string.argtypes = [i]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(lib, err: int, name: str) -> None:
    """Raise if a launch's cudaError_t is not 0."""
    if err:
        msg = lib.ldpc_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


def layered_launch(qv, layout, rule):
    """Check the (nbt, VG, Z, 4) Qv tiles of a streaming sweep's launch
    against the layout and rule (Qv of ``posterior_dtype``); returns
    ``lane_launch``'s (table pointer array, dims, park, stream): the sweep
    is the resident layered kernel's, and parks where it parks."""
    if qv.dtype != posterior_dtype(rule):
        raise TypeError(f"qv must be {posterior_dtype(rule)} for {type(rule).__name__}")
    return lane_launch(qv, layout, rule, 0, True)


def _launch_args(x, layout, rule, max_iterations):
    """The checks every layered or lane launch makes on its (nbt, P, Z, Bt)
    tiles x; returns (table pointer array, dims, stream)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    nbt, VG, Z, Bt = x.shape
    if not x.is_contiguous():
        raise TypeError("planes must be contiguous")
    if (VG, Z) != (layout.VG, layout.Z):
        raise ValueError(f"planes {(VG, Z)} do not match the layout")
    if not takes_storage(rule):
        raise TypeError(f"unsupported message storage {rule.storage_dtype}")
    check_degree_cap(layout, rule)
    if max_iterations < 0:
        raise ValueError("max_iterations must be >= 0")
    tables = [getattr(layout, name) for name in LAYERED_TABLES]
    if any(
        t.device != x.device or t.dtype != torch.int32 or not t.is_contiguous()
        for t in tables
    ):
        raise TypeError("layout tables must be contiguous int32 on the planes' device")
    ptrs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    dims = (nbt, layout.CG, layout.E, VG, Z, Bt, layout.max_chk_degree)
    return ptrs, dims, torch.cuda.current_stream(x.device).cuda_stream


def shared_ints(layout, with_park: bool, park_bytes: int = 4) -> int:
    """Dynamic shared memory, in 4-byte words, of a block of a kernel with a
    thread per lane (``smem_bytes`` of ``csrc/lanes.cuh``): the control
    words; the layout tables it copies, rounded up to 16-byte rows
    (``chk_cs`` and ``var_cs`` with an end entry, a repeat flag a check
    group, and eight tables an edge: ``syn_vg``, ``rec_plane`` and
    ``rec_group`` times Z, ``syn_rot``, ``chk_rot``, ``syn_mask``,
    ``rec_slot`` and ``rec_rot`` as they are); and, ``with_park``, the
    layered park of max degree x Z x 4 deltas of ``park_bytes`` each (8
    for the f64 instances)."""
    tables = 2 * layout.CG + layout.VG + 2 + 8 * layout.E
    park = layout.max_chk_degree * layout.Z * BT * park_bytes // 4 if with_park else 0
    return _CONTROL_INTS + -(-tables // 4) * 4 + park


def posterior_dtype(rule):
    """The type of a layered kernel's Qv: int16 for an i8 rule, the storage
    type (f32 or f64) for a float rule, f32 for min-sum."""
    if is_i8(rule):
        return torch.int16
    return rule.storage_dtype if is_float_rule(rule) else torch.float32


def park_dtype(rule):
    """The type of a layered kernel's parked deltas: int32 for an i8 rule,
    f64 for an f64 rule, f32 otherwise."""
    if is_i8(rule):
        return torch.int32
    return torch.float64 if rule.storage_dtype == torch.float64 else torch.float32


def parks_in_device_memory(layout, park_bytes: int = 4) -> bool:
    """Whether a layered kernel with a thread per lane parks its deltas in
    device memory: the tables and the park do not fit a block's shared
    memory together (CCSDS C2)."""
    return 4 * shared_ints(layout, True, park_bytes) > MAX_SHARED_BYTES


def lane_launch(x, layout, rule, max_iterations, with_park):
    """The checks and arguments of a launch of a kernel with a thread per
    lane, on its (nbt, VG, Z, Bt) tiles x: those of every layered launch,
    tiles of exactly 4 frames (a thread holds all four) and the tables in
    shared memory; returns (table pointer array, dims, park, stream):
    ``dims`` is (nbt, CG, E, VG, Z, Bt, max degree); ``park`` the
    device-memory park, or None. The park (``with_park``: the layered
    kernels; deltas of ``park_dtype``) goes after the tables when it fits
    there, else in device memory."""
    if x.shape[-1] != BT:
        raise ValueError(f"tile width {x.shape[-1]}: the kernel takes {BT}")
    tables, dims, stream = _launch_args(x, layout, rule, max_iterations)
    if 4 * shared_ints(layout, False) > MAX_SHARED_BYTES:
        raise ValueError("the layout tables do not fit a block's shared memory")
    park = None
    dtype = park_dtype(rule)
    if with_park and parks_in_device_memory(layout, dtype.itemsize):
        nbt, _, Z, Bt = x.shape
        park = torch.empty((nbt, layout.max_chk_degree, Z, Bt), dtype=dtype,
                           device=x.device)
    return tables, dims, park, stream


def check_bits(bits0_t, qv0_t):
    if bits0_t.dtype != torch.int8 or bits0_t.shape != qv0_t.shape:
        raise TypeError("bits0_t must be int8 of the planes' shape")
    if bits0_t.device != qv0_t.device:
        raise ValueError("qv0_t and bits0_t must lie on one device")


def resident_layered_decode(qv0_t, bits0_t, layout, rule, max_iterations: int):
    """(qv0, bits0) -> (bits, iters, conv) for every tile.

    qv0_t: (nbt, VG, Z, Bt) posteriors init (quantized channel LLRs), f32,
    or int16 for an i8 rule; bits0_t: (nbt, VG, Z, Bt) int8 hard decisions
    of the *raw* channel LLRs; layout: a ``convert.DeviceLayout`` on the
    same device; rule: a ``MinSumRule``, an i8 rule or a float rule (f32
    or f64 Qv, its storage type). Returns bits (nbt, VG, Z, Bt) int8
    (frozen at per-frame convergence, final posterior sign otherwise),
    iters (nbt, Bt) int32 and conv (nbt, Bt) int32.
    """
    if qv0_t.device.type == "cpu":
        return resident_layered_decode_reference(
            qv0_t, bits0_t, layout, rule, max_iterations
        )
    if is_i8(rule):
        return resident_layered_decode_i8(qv0_t, bits0_t, layout, rule, max_iterations)
    if is_float_rule(rule):
        return resident_layered_decode_float(qv0_t, bits0_t, layout, rule, max_iterations)
    qv = qv0_t.clone(memory_format=torch.contiguous_format)
    check_bits(bits0_t, qv)
    if qv.dtype != torch.float32:
        raise TypeError("qv0_t must be float32")
    tables, dims, park, stream = lane_launch(qv, layout, rule, max_iterations, True)
    nbt, _, Z, Bt = qv.shape
    dev = qv.device
    bits = bits0_t.clone(memory_format=torch.contiguous_format)
    rcv = torch.zeros((nbt, layout.E, Z, Bt), dtype=rule.storage_dtype, device=dev)
    iters = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    conv = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.ldpc_resident_layered_decode(
        qv.data_ptr(), rcv.data_ptr(), bits.data_ptr(), iters.data_ptr(),
        conv.data_ptr(), None if park is None else park.data_ptr(), tables,
        *dims, int(max_iterations), LANE_THREADS, rule.big, rule.scale,
        _MSG_DTYPES[rule.storage_dtype], stream,
    )
    raise_on(lib, err, "resident_layered_decode")
    resident_layered_decode.launches += 1
    return bits, iters, conv


def resident_layered_decode_i8(qv0_t, bits0_t, layout, rule, max_iterations: int):
    """``resident_layered_decode`` for an i8 rule, through the kernel's int8
    instances: qv0_t (nbt, VG, Z, 4) int16, Rcv int8, int32 arithmetic;
    same arguments and results. Check degree at most
    ``I8_MAX_CHECK_DEGREE``."""
    if qv0_t.device.type == "cpu":
        return resident_layered_decode_reference(
            qv0_t, bits0_t, layout, rule, max_iterations
        )
    if not is_i8(rule):
        raise TypeError(f"{type(rule).__name__} is not an i8 rule")
    qv = qv0_t.clone(memory_format=torch.contiguous_format)
    check_bits(bits0_t, qv)
    if qv.dtype != torch.int16:
        raise TypeError("qv0_t must be int16 for an i8 rule")
    tables, dims, park, stream = lane_launch(qv, layout, rule, max_iterations, True)
    nbt, _, Z, Bt = qv.shape
    dev = qv.device
    bits = bits0_t.clone(memory_format=torch.contiguous_format)
    rcv = torch.zeros((nbt, layout.E, Z, Bt), dtype=torch.int8, device=dev)
    iters = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    conv = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    lib = _lib_i8()
    err = lib.ldpc_resident_layered_i8_decode(
        qv.data_ptr(), rcv.data_ptr(), bits.data_ptr(), iters.data_ptr(),
        conv.data_ptr(), None if park is None else park.data_ptr(), tables,
        *dims, int(max_iterations), I8_LAYERED_THREADS, rule.kind, rule.flags, stream,
    )
    raise_on(lib, err, "resident_layered_decode_i8")
    resident_layered_decode_i8.launches += 1
    return bits, iters, conv


def resident_layered_decode_float(qv0_t, bits0_t, layout, rule, max_iterations: int):
    """``resident_layered_decode`` for a float rule, through the kernel's
    float-rule instances: qv0_t (nbt, VG, Z, 4) and Rcv in the rule's
    storage type (f32 or f64), computed in it; same arguments and results.
    Check degree at most ``rule.max_check_degree``."""
    if qv0_t.device.type == "cpu":
        return resident_layered_decode_reference(
            qv0_t, bits0_t, layout, rule, max_iterations
        )
    if not is_float_rule(rule):
        raise TypeError(f"{type(rule).__name__} is not a float rule")
    qv = qv0_t.clone(memory_format=torch.contiguous_format)
    check_bits(bits0_t, qv)
    if qv.dtype != rule.storage_dtype:
        raise TypeError(f"qv0_t must be {rule.storage_dtype} for {type(rule).__name__}")
    tables, dims, park, stream = lane_launch(qv, layout, rule, max_iterations, True)
    nbt, _, Z, Bt = qv.shape
    dev = qv.device
    bits = bits0_t.clone(memory_format=torch.contiguous_format)
    rcv = torch.zeros((nbt, layout.E, Z, Bt), dtype=rule.storage_dtype, device=dev)
    iters = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    conv = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    lib = _lib_float(FLOAT_SOURCES[rule.storage_dtype])
    err = lib.ldpc_resident_layered_float_decode(
        qv.data_ptr(), rcv.data_ptr(), bits.data_ptr(), iters.data_ptr(),
        conv.data_ptr(), None if park is None else park.data_ptr(), tables,
        *dims, int(max_iterations), LANE_THREADS, rule.kind, rule.big, rule.clamp,
        rule.prod_max, stream,
    )
    raise_on(lib, err, "resident_layered_decode_float")
    resident_layered_decode_float.launches += 1
    return bits, iters, conv


#: kernel launches since the count was last set to 0 (the min-sum
#: instances; the int8 and float-rule instances count on their wrappers)
resident_layered_decode.launches = 0
resident_layered_decode_i8.launches = 0
resident_layered_decode_float.launches = 0


def resident_layered_decode_reference(
    qv0_t, bits0_t, layout, rule, max_iterations: int
):
    """The plain PyTorch version of ``resident_layered_decode``, on any
    device, same arguments and results. Tiles are independent, so it
    decodes them together; per-tile early exit changes no output."""
    return on_planes(layered_decode_planes, qv0_t, bits0_t, layout, rule,
                     max_iterations)


def on_planes(decode, qv0_t, bits0_t, layout, rule, max_iterations):
    """Run a plain decode of (VG, Z, N) planes on (nbt, VG, Z, Bt) tiles:
    ``decode(qv0, hard0, layout, rule, max_iterations)`` -> the tiled
    (bits int8, iters (nbt, Bt) int32, conv (nbt, Bt) int32)."""
    nbt, VG, Z, Bt = qv0_t.shape

    def untile(x):
        return x.permute(1, 2, 0, 3).reshape(VG, Z, nbt * Bt)

    bits, iters, conv = decode(
        untile(qv0_t), untile(bits0_t) != 0, layout, rule, max_iterations
    )
    bits = bits.to(torch.int8).reshape(VG, Z, nbt, Bt).permute(2, 0, 1, 3)
    return (
        bits.contiguous(),
        iters.reshape(nbt, Bt),
        conv.to(torch.int32).reshape(nbt, Bt),
    )


def plane_tables(layout, dev):
    """(src, valid, groups) of the plain layered sweeps on (VG*Z, N)
    posteriors: src (E, Z) the flat Qv row check lane c of edge e reads
    (variable lane (c - s) mod Z), valid (E, Z, 1) False at the missing
    lanes, groups [(g, first edge, degree)] in layer order."""
    Z = layout.Z
    lane = torch.arange(Z, device=dev)
    vg = layout.syn_vg.to(device=dev, dtype=torch.long)
    rot = layout.syn_rot.to(device=dev, dtype=torch.long)
    src = vg[:, None] * Z + (lane[None, :] - rot[:, None]) % Z
    valid = (lane[None, :] != layout.syn_mask.to(dev)[:, None])[..., None]
    groups = [
        (m.g0 + j, m.ebase + j * m.d, m.d)
        for m in layout.chk_meta
        if m.d
        for j in range(m.g1 - m.g0)
    ]
    return src, valid, groups


def message_sweep(qv, rcv, layout, rule, tables):
    """One plain layered sweep in place on qv (VG*Z, N) posteriors (f32;
    int16 for an i8 rule, f64 for an f64 rule) and rcv (E, Z, N) messages
    in the rule's storage type, computing in the rule's compute type, with
    ``rule.big`` at the missing lanes; ``tables`` from ``plane_tables``."""
    src, valid, groups = tables
    for _, e0, d in groups:
        idx = src[e0 : e0 + d]  # (d, Z)
        ok_lane = valid[e0 : e0 + d]
        rold = rcv[e0 : e0 + d].to(rule.compute_dtype)
        x = torch.where(ok_lane, rule.layered_x(qv[idx], rold), rule.big)
        rn = torch.where(ok_lane, rule.check(x), 0)
        delta = rn - rold  # before the store: rold may view rcv (f32)
        rcv[e0 : e0 + d] = rn.to(rule.storage_dtype)
        # in edge order: two edges into one variable group add in turn
        # (int16 Qv wraps as the JAX package's does)
        for t in range(d):
            qv[idx[t]] += delta[t].to(qv.dtype)


def layered_loop(qv0, hard0, layout, max_iterations, tables, sweep):
    """The plain layered decode loop on (VG, Z, N) planes: ``sweep(qv)``
    runs one sweep in place on the (VG*Z, N) posteriors; the syndrome,
    freeze and stop follow the kernels'. Returns bits (VG, Z, N) bool,
    iterations (N,) int32 and success (N,) bool."""
    VG, Z, N = qv0.shape
    dev = qv0.device
    src, valid, _ = tables

    def check_ok(hard):  # (VG*Z, N) bool -> (N,) all checks satisfied
        h = (hard[src] & valid).to(torch.int32)  # (E, Z, N)
        ok = torch.ones(N, dtype=torch.bool, device=dev)
        for m in layout.chk_meta:
            if not m.d:
                continue
            blk = h[m.ebase : m.ebase + (m.g1 - m.g0) * m.d]
            par = blk.reshape(m.g1 - m.g0, m.d, Z, N).sum(dim=1) & 1
            ok &= ~par.bool().flatten(0, 1).any(dim=0)
        return ok

    qv = qv0.reshape(VG * Z, N).clone()
    hard = hard0.reshape(VG * Z, N)
    conv = check_ok(hard)
    iters = torch.zeros(N, dtype=torch.int32, device=dev)
    frozen = hard
    it = 0
    while it < max_iterations and not bool(conv.all()):
        sweep(qv)
        it += 1
        hard = qv <= 0
        ok = check_ok(hard)
        newly = ok & ~conv
        iters = torch.where(newly, it, iters)
        frozen = torch.where(newly, hard, frozen)
        conv = conv | ok
    bits = torch.where(conv, frozen, hard).reshape(VG, Z, N)
    iters = torch.where(conv, iters, max_iterations).to(torch.int32)
    return bits, iters, conv


def layered_decode_planes(qv0, hard0, layout, rule, max_iterations: int):
    """Plain layered decode of (VG, Z, N) planes with Rcv messages.

    qv0: posteriors init (f32; int16 for an i8 rule, f64 for an f64 rule); hard0: bool
    raw-channel hard decisions; rule: ``layered_x(qv, rold)``, ``check(x)``
    on (d, Z, N), ``big`` (the missing-lane poke), ``storage_dtype`` (Rcv)
    and ``compute_dtype``. Returns bits (VG, Z, N) bool, iterations (N,)
    int32 and success (N,) bool.
    """
    _, Z, N = qv0.shape
    tables = plane_tables(layout, qv0.device)
    rcv = torch.zeros((layout.E, Z, N), dtype=rule.storage_dtype, device=qv0.device)
    return layered_loop(
        qv0, hard0, layout, max_iterations, tables,
        lambda qv: message_sweep(qv, rcv, layout, rule, tables),
    )
