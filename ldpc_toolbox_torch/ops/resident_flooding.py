"""Whole flooding decode of frame tiles.

``resident_flooding_decode`` keeps the contract of the JAX package's two
resident flooding kernels, ``ops/resident_flooding_dual.py
resident_flooding_dual_decode`` and ``ops/resident_flooding.py
resident_flooding_decode``: it takes a batch cut into tiles of Bt frames,
``(nbt, VG, Z, Bt)`` channel planes and raw-channel bits, runs all
iterations (check phase, variable phase, syndrome, per-frame freeze at
first convergence, per-tile early exit) and returns the hard bits,
iteration counts and convergence flags. One function serves both TPU
kernels because they compute the same thing: they differ only in how the
state fits the TPU's vector memory (two message arrays, or one array
aliased between the phases). On this card the state lives in device
memory either way, and the CUDA kernel keeps one array.

On a CUDA tensor it launches ``flooding_ring_kernel`` of
``csrc/flooding_ring.cuh``, built by ``csrc/flooding.cu`` (one thread block
per tile of 4 frames, a thread per lane, all iterations in one launch, one
message array in check-major cells, every operand of a pass brought into
shared memory by bulk copies through a ring of two stages of
``ring_stage_bytes``) or raises, also for a tile of another width; on a CPU
tensor it runs the plain version ``resident_flooding_decode_reference``,
built from the plain phases (any width).

Semantics (bit-identical to the JAX package's kernels): v2c starts as the
channel planes rolled into check coordinates with big at the missing
lanes; each iteration runs the whole check phase, then the whole variable
phase; the syndrome tests the posterior hard bits; a frame's bits and
count freeze at its first passing iteration; iteration 0 tests the
raw-channel bits, so a frame can finish with 0 iterations; a frame that
never converges gets ``max_iterations`` and its last posterior bits (the
raw-channel bits if no iteration ran).

The i8 rules (``MinstarApproxI8Rule``, ``AminstarI8Rule``) take int8
channel planes (the quantized LLRs) and int8 messages and compute in
int32: v2c = clip(tot - c2v, +-127), tot = q (clipped to +-116 for a
degree-1 group under Deg1Clip) plus the c2v, clipped to +-127 under Jones;
the hard decision is tot <= 0. On a CUDA tensor ``resident_flooding_decode``
passes them to ``resident_flooding_decode_i8``, the wrapper of the kernel's
int8 instances (``csrc/flooding_i8.cu``, ``fused_bp2.I8_FLOODING_THREADS``
a block), which counts their launches apart.

The float rules (``PhiRule``, ``TanhRule``, ``MinstarApproxRule``,
``AminstarRule``) take channel planes and messages in their storage type,
f32 or f64, and compute in it, with the min-sum variable rule (sum in
slot order, each output tot - own) and big, the type's largest value, at
the missing lanes. On a CUDA tensor ``resident_flooding_decode`` passes
them to ``resident_flooding_decode_float``, the wrapper of the kernel's
float-rule instances (``csrc/flooding_f32.cu`` and ``_f64.cu``), which
counts their launches apart. The f64 instances give a thread one frame of
a lane, ``fused_bp2.F64_UNIT_THREADS`` threads a block; the f32 instances
give a check lane's thread a frame pair and a variable lane's thread a
lane's four frames, ``fused_bp2.F32_UNIT_THREADS`` threads a block
(``csrc/float_rules.cuh`` FloatRule's FloodUnits and VarUnits).
"""

from __future__ import annotations

import functools
import math

import torch

from .fused_bp2 import (
    _MSG_DTYPES,
    FLOAT_FLOODING_SOURCES,
    _check_planes,
    flooding_float_lib,
    flooding_i8_lib,
    flooding_lib,
    fused_check_reference,
    fused_syndrome_freeze_reference,
    fused_var_reference,
    is_float_rule,
    is_i8,
    raise_on,
    unit_threads,
)
from .resident_layered import BT, LANE_THREADS, lane_launch, shared_ints

__all__ = [
    "resident_flooding_decode",
    "resident_flooding_decode_float",
    "resident_flooding_decode_i8",
    "resident_flooding_decode_reference",
    "flooding_loop",
    "decode_loop",
    "ring_stage_bytes",
]

#: the min-sum kernel's ring (``csrc/flooding_ring.cuh``): its stages, the
#: bytes before them (their barriers), and the least bytes a stage takes
RING_STAGES = 2
RING_HEAD_BYTES = 128
RING_MIN_STAGE_BYTES = 32 * 1024


def _round16(b):
    return -(-b // 16) * 16


def _window_bytes(n, lane_bytes):
    """The stage bytes of a window of n lanes (``ring::window_bytes``)."""
    return _round16(n * lane_bytes) + 16


def _wrapped_bytes(n, lane_bytes):
    """The stage bytes of a window that may wrap at Z (``ring::wrapped_bytes``)."""
    return _round16(n * lane_bytes) + 48


def ring_stage_bytes(layout, itemsize: int, block_bytes: int) -> int:
    """The bytes of each stage of the min-sum kernel's ring for a layout
    and a message size (4: f32, 2: bf16), on a card whose blocks may take
    ``block_bytes`` of shared memory two an SM (``ldpc_ring_block_bytes``).

    A stage holds the largest whole group of each pass, at least
    ``RING_MIN_STAGE_BYTES`` (``csrc/flooding_ring.cuh``: a check group's
    message rows, one window; a variable group's q window and message
    rows, a window each; a check group's hard-bit rows, a window each),
    within what is left beside the tables and the barriers, in whole
    128-byte rows; where a group does not fit, the kernel cuts it into
    chunks of lanes (a chunk of a rotated row may wrap: two windows).
    Raises ``ValueError`` when not even a chunk of one lane of the largest
    group fits."""
    lane = BT * itemsize
    Z, dc = layout.Z, layout.max_chk_degree
    dv = max((m.d for m in layout.var_meta), default=0)

    # a chunk of one lane of the largest group of each pass
    least = max(dc * _window_bytes(1, lane),
                _window_bytes(1, lane) + dv * _wrapped_bytes(1, lane),
                dc * _wrapped_bytes(1, BT))
    room = (block_bytes - 4 * shared_ints(layout, False) - RING_HEAD_BYTES) // RING_STAGES
    room = room // 128 * 128
    if room < least:
        raise ValueError(
            f"the ring's stages ({least} bytes at least) do not fit beside the "
            f"layout tables in a block's {block_bytes} bytes of shared memory"
        )
    # the largest whole group of each pass, its rows as they lie
    whole = max(_window_bytes(dc * Z, lane), (1 + dv) * _window_bytes(Z, lane),
                dc * _window_bytes(Z, BT), RING_MIN_STAGE_BYTES)
    return min(room, -(-whole // 128) * 128)


@functools.cache
def _ring_block_bytes(index: int) -> int:
    got = flooding_lib().ldpc_ring_block_bytes(index)
    raise_on(-got if got < 0 else 0, "ldpc_ring_block_bytes")
    return got


def _scratch(shape, dtype, device):
    """An empty tensor of ``shape`` with 16 bytes of its allocation after
    it: the min-sum kernel copies whole 16-byte rows, which may reach past
    the last cell."""
    n = math.prod(shape)
    slack = 16 // torch.empty((), dtype=dtype).element_size()
    return torch.empty(n + slack, dtype=dtype, device=device)[:n].view(shape)


def _launch_planes(q_t, bits0_t, layout, rule, max_iterations):
    """The checks of a resident flooding launch on its tiles; returns the
    ``lane_launch`` arguments and the kernel's scratch and outputs (msg,
    post, bits, iters, conv)."""
    _check_planes(q_t, layout.VG, layout, rule.storage_dtype, "q_t")
    _check_planes(bits0_t, layout.VG, layout, torch.int8, "bits0_t")
    if bits0_t.shape != q_t.shape or bits0_t.device != q_t.device:
        raise ValueError("q_t and bits0_t must match in shape and device")
    tables, dims, _, stream = lane_launch(q_t, layout, rule, max_iterations, False)
    if q_t.data_ptr() % 16:
        raise ValueError("q_t must start on a 16-byte boundary")
    nbt, VG, Z, Bt = q_t.shape
    dev = q_t.device
    state = (
        _scratch((nbt, layout.E, Z, Bt), q_t.dtype, dev),
        _scratch((nbt, VG, Z, Bt), torch.int8, dev),
        bits0_t.clone(memory_format=torch.contiguous_format),
        torch.empty((nbt, Bt), dtype=torch.int32, device=dev),
        torch.empty((nbt, Bt), dtype=torch.int32, device=dev),
    )
    return tables, dims, stream, state


def resident_flooding_decode(q_t, bits0_t, layout, rule, max_iterations: int):
    """(q, bits0) -> (bits, iters, conv) for every tile.

    q_t: (nbt, VG, Z, Bt) channel planes in the rule's storage type (int8
    quantized LLRs for an i8 rule); bits0_t: (nbt, VG, Z, Bt) int8 hard
    decisions of the raw channel LLRs; layout: a ``convert.DeviceLayout``
    on the same device; rule: a ``MinSumRule``, an i8 rule or a float rule
    (on a CUDA tensor passed to ``resident_flooding_decode_i8`` or
    ``resident_flooding_decode_float``). Returns bits (nbt, VG, Z, Bt)
    int8, iters (nbt, Bt) int32 and conv (nbt, Bt) int32.
    """
    if q_t.device.type == "cpu":
        return resident_flooding_decode_reference(
            q_t, bits0_t, layout, rule, max_iterations
        )
    if is_i8(rule):
        return resident_flooding_decode_i8(q_t, bits0_t, layout, rule, max_iterations)
    if is_float_rule(rule):
        return resident_flooding_decode_float(q_t, bits0_t, layout, rule, max_iterations)
    tables, dims, stream, state = _launch_planes(
        q_t, bits0_t, layout, rule, max_iterations
    )
    msg, post, bits, iters, conv = state
    stage = ring_stage_bytes(
        layout, q_t.element_size(), _ring_block_bytes(q_t.device.index or 0)
    )
    if q_t.numel() * q_t.element_size() % 16:
        # the kernel's copies of q's last row may reach 8 bytes past it
        q_t = _scratch(q_t.shape, q_t.dtype, q_t.device).copy_(q_t)
    raise_on(
        flooding_lib().ldpc_resident_flooding_decode(
            msg.data_ptr(), q_t.data_ptr(), post.data_ptr(), bits.data_ptr(),
            iters.data_ptr(), conv.data_ptr(), tables, *dims,
            int(max_iterations), LANE_THREADS, rule.big, rule.scale,
            _MSG_DTYPES[rule.storage_dtype], stage, stream,
        ),
        "resident_flooding_decode",
    )
    resident_flooding_decode.launches += 1
    return bits, iters, conv


def resident_flooding_decode_i8(q_t, bits0_t, layout, rule, max_iterations: int):
    """``resident_flooding_decode`` for an i8 rule, through the kernel's
    int8 instances (``csrc/flooding_i8.cu``): int8 channel planes and
    messages, int32 arithmetic, the rule's Jones, PartialHardLimit and
    Deg1Clip flags; same arguments and results. Check degree at most
    ``fused_bp2.I8_MAX_CHECK_DEGREE``."""
    if q_t.device.type == "cpu":
        return resident_flooding_decode_reference(
            q_t, bits0_t, layout, rule, max_iterations
        )
    if not is_i8(rule):
        raise TypeError(f"{type(rule).__name__} is not an i8 rule")
    tables, dims, stream, state = _launch_planes(
        q_t, bits0_t, layout, rule, max_iterations
    )
    msg, post, bits, iters, conv = state
    lib = flooding_i8_lib()
    err = lib.ldpc_resident_flooding_i8_decode(
        msg.data_ptr(), q_t.data_ptr(), post.data_ptr(), bits.data_ptr(),
        iters.data_ptr(), conv.data_ptr(), tables, *dims, int(max_iterations),
        unit_threads(rule, LANE_THREADS), rule.kind, rule.flags, stream,
    )
    if err:
        text = lib.ldpc_flooding_i8_error_string(err).decode()
        raise RuntimeError(f"resident_flooding_decode_i8 launch failed: {text}")
    resident_flooding_decode_i8.launches += 1
    return bits, iters, conv


def resident_flooding_decode_float(q_t, bits0_t, layout, rule, max_iterations: int):
    """``resident_flooding_decode`` for a float rule, through the kernel's
    float-rule instances (``csrc/flooding_f32.cu``, ``_f64.cu``): channel
    planes and messages in the rule's storage type, computed in it; same
    arguments and results. Check degree at most ``rule.max_check_degree``."""
    if q_t.device.type == "cpu":
        return resident_flooding_decode_reference(
            q_t, bits0_t, layout, rule, max_iterations
        )
    if not is_float_rule(rule):
        raise TypeError(f"{type(rule).__name__} is not a float rule")
    tables, dims, stream, state = _launch_planes(
        q_t, bits0_t, layout, rule, max_iterations
    )
    msg, post, bits, iters, conv = state
    lib = flooding_float_lib(FLOAT_FLOODING_SOURCES[rule.storage_dtype])
    err = lib.ldpc_resident_flooding_float_decode(
        msg.data_ptr(), q_t.data_ptr(), post.data_ptr(), bits.data_ptr(),
        iters.data_ptr(), conv.data_ptr(), tables, *dims, int(max_iterations),
        unit_threads(rule, LANE_THREADS), rule.kind, rule.big, rule.clamp, rule.prod_max,
        stream,
    )
    if err:
        text = lib.ldpc_flooding_float_error_string(err).decode()
        raise RuntimeError(f"resident_flooding_decode_float launch failed: {text}")
    resident_flooding_decode_float.launches += 1
    return bits, iters, conv


#: kernel launches since the count was last set to 0 (the min-sum
#: instances; the int8 and float-rule instances count on their wrappers)
resident_flooding_decode.launches = 0
resident_flooding_decode_i8.launches = 0
resident_flooding_decode_float.launches = 0


def resident_flooding_decode_reference(
    q_t, bits0_t, layout, rule, max_iterations: int
):
    """The plain PyTorch version of ``resident_flooding_decode``, on any
    device, same arguments and results. Tiles are independent, so it
    decodes them together and stops when every frame has converged;
    per-tile early exit changes no output."""
    return flooding_loop(
        q_t, bits0_t, layout, rule, max_iterations,
        fused_check_reference, fused_var_reference,
        fused_syndrome_freeze_reference,
    )


def flooding_loop(q_t, bits0_t, layout, rule, max_iterations, check, var,
                  freeze):
    """The flooding decode as a host loop over the phases ``check(v2c,
    layout, rule)``, ``var(c2v, q, layout, rule)`` and the test and freeze
    ``freeze(bits, frozen, conv, iters, it, counter, layout)``
    (``fused_syndrome_freeze``'s contract); same arguments and results as
    ``resident_flooding_decode``. It stops when every frame has converged
    (one host read an iteration) or after ``max_iterations``."""
    v2c = var(None, q_t, layout, rule)[0]

    def step():
        nonlocal v2c
        v2c, bits = var(check(v2c, layout, rule), q_t, layout, rule)
        return bits

    return decode_loop(
        bits0_t, bits0_t, step, functools.partial(freeze, layout=layout),
        max_iterations,
    )


def decode_loop(bits0_t, post0_t, step, freeze, max_iterations):
    """The host loop of a plain whole decode on (nbt, VG, Z, Bt) tiles:
    iteration 0 tests the raw-channel bits ``bits0_t``; each iteration
    ``step()`` returns the posterior hard bits, and ``freeze(bits, frozen,
    conv, iters, it, counter)`` tests them and freezes in place
    (``fused_syndrome_freeze``'s contract without its layout; one host read
    an iteration, the counter): a frame's bits and count freeze at its
    first passing iteration; the loop stops once every frame has passed or
    after ``max_iterations``. A frame that never passes gets
    ``max_iterations`` and its last posterior bits (``post0_t`` when no
    iteration ran). Returns (bits int8, iters (nbt, Bt) int32, conv (nbt,
    Bt) int32)."""
    nbt, _, _, bt = bits0_t.shape
    dev = bits0_t.device
    frozen = torch.empty_like(bits0_t)
    conv = torch.zeros(nbt * bt, dtype=torch.bool, device=dev)
    iters = torch.zeros(nbt * bt, dtype=torch.int32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    freeze(bits0_t, frozen, conv, iters, 0, counter)
    bits = post0_t
    it = 0
    while it < max_iterations and int(counter):
        bits = step()
        it += 1
        freeze(bits, frozen, conv, iters, it, counter)
    conv = conv.reshape(nbt, bt)
    bits = torch.where(conv[:, None, None, :], frozen, bits)
    iters = torch.where(conv, iters.reshape(nbt, bt), max_iterations).to(torch.int32)
    return bits.contiguous(), iters, conv.to(torch.int32)
