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

On a CUDA tensor it launches ``resident_flooding_kernel`` of
``csrc/flooding.cu`` (one thread block per tile of 4 frames, a thread per
lane, all iterations in one launch, one message array in check-major
cells) or raises, also for a tile of another width; on a CPU tensor it
runs the plain version ``resident_flooding_decode_reference``, built from
the plain phases (any width).

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
a lane, ``fused_bp2.F64_UNIT_THREADS`` threads a block.
"""

from __future__ import annotations

import functools

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
from .resident_layered import LANE_THREADS, lane_launch

__all__ = [
    "resident_flooding_decode",
    "resident_flooding_decode_float",
    "resident_flooding_decode_i8",
    "resident_flooding_decode_reference",
    "flooding_loop",
    "decode_loop",
]


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
        torch.empty((nbt, layout.E, Z, Bt), dtype=q_t.dtype, device=dev),
        torch.empty((nbt, VG, Z, Bt), dtype=torch.int8, device=dev),
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
    raise_on(
        flooding_lib().ldpc_resident_flooding_decode(
            msg.data_ptr(), q_t.data_ptr(), post.data_ptr(), bits.data_ptr(),
            iters.data_ptr(), conv.data_ptr(), tables, *dims,
            int(max_iterations), LANE_THREADS, rule.big, rule.scale,
            _MSG_DTYPES[rule.storage_dtype], stream,
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
