"""Whole horizontal-layered decode of frame tiles.

``resident_layered_decode`` keeps the contract of
``ldpc_toolbox_tpu.ops.resident_layered.resident_layered_decode``: it takes
a batch cut into tiles of Bt frames, ``(nbt, VG, Z, Bt)`` planes, runs all
iterations (layered sweep, syndrome test, per-frame freeze at first
convergence, per-tile early exit) and returns the hard bits, iteration
counts and convergence flags. On a CUDA tensor it launches the hand-written
kernel of ``csrc/resident_layered.cu`` (one thread block per tile) or
raises; on a CPU tensor it runs the plain version
``resident_layered_decode_reference``.

Semantics (bit-identical to the JAX package's kernel and jnp path): layers
are the check groups in bucket-major order; every x of a group is formed
from the layer-entry Qv; the group's deltas ``Rnew - Rold`` (Rnew in f32,
Rold as loaded from its storage type) are then added to Qv in edge order,
one rounding per addition, so two edges of one group into the same
variable group give ``(Qv + d1) + d2``. Iteration 0 tests the raw-channel
hard bits, so a frame can finish with 0 iterations.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fused_bp2 import BT

__all__ = [
    "BT",
    "BLOCK_THREADS",
    "resident_layered_decode",
    "resident_layered_decode_reference",
    "layered_decode_planes",
]

#: threads per block; a multiple of BT, so each thread keeps one frame
BLOCK_THREADS = 512
#: dynamic shared memory a block may use on Hopper
MAX_SHARED_BYTES = 232_448

_MSG_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = _build.load("resident_layered")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_resident_layered_decode.argtypes = [p] * 10 + [i] * 9 + [f, f, i, p]
    lib.ldpc_resident_layered_decode.restype = i
    lib.ldpc_cuda_error_string.argtypes = [i]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _shared_bytes(layout, bt: int) -> int:
    return 4 * layout.max_chk_degree * layout.Z * bt + 4 * (4 * bt + 2)


def resident_layered_decode(qv0_t, bits0_t, layout, rule, max_iterations: int):
    """(qv0, bits0) -> (bits, iters, conv) for every tile.

    qv0_t: (nbt, VG, Z, Bt) f32 posteriors init (quantized channel LLRs);
    bits0_t: (nbt, VG, Z, Bt) int8 hard decisions of the *raw* channel
    LLRs; layout: a ``convert.DeviceLayout`` on the same device; rule: a
    ``MinSumRule``. Returns bits (nbt, VG, Z, Bt) int8 (frozen at per-frame
    convergence, final posterior sign otherwise), iters (nbt, Bt) int32 and
    conv (nbt, Bt) int32.
    """
    if qv0_t.device.type == "cpu":
        return resident_layered_decode_reference(
            qv0_t, bits0_t, layout, rule, max_iterations
        )
    if qv0_t.device.type != "cuda":
        raise ValueError(f"unsupported device {qv0_t.device}")
    nbt, VG, Z, Bt = qv0_t.shape
    if qv0_t.dtype != torch.float32 or bits0_t.dtype != torch.int8:
        raise TypeError("qv0_t must be float32 and bits0_t int8")
    if bits0_t.shape != qv0_t.shape or bits0_t.device != qv0_t.device:
        raise ValueError("qv0_t and bits0_t must match in shape and device")
    if (VG, Z) != (layout.VG, layout.Z):
        raise ValueError(f"planes {(VG, Z)} do not match the layout")
    if layout.chk_cs.device != qv0_t.device:
        raise ValueError("layout tables must lie on the decode device")
    if rule.storage_dtype not in _MSG_DTYPES:
        raise TypeError(f"unsupported message storage {rule.storage_dtype}")
    if BLOCK_THREADS % Bt:
        raise ValueError(f"tile width {Bt} must divide {BLOCK_THREADS}")
    smem = _shared_bytes(layout, Bt)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"check degree {layout.max_chk_degree} at Z={Z}, Bt={Bt} needs "
            f"{smem} bytes of shared memory (at most {MAX_SHARED_BYTES})"
        )
    if max_iterations < 0:
        raise ValueError("max_iterations must be >= 0")
    lib = _lib()
    dev = qv0_t.device
    qv = qv0_t.clone(memory_format=torch.contiguous_format)
    bits = bits0_t.clone(memory_format=torch.contiguous_format)
    rcv = torch.zeros(
        (nbt, layout.E, Z, Bt), dtype=rule.storage_dtype, device=dev
    )
    iters = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    conv = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    tables = [
        layout.chk_cs, layout.syn_vg, layout.syn_rot, layout.chk_rot,
        layout.syn_mask,
    ]
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in tables):
        raise TypeError("layout tables must be contiguous int32")
    err = lib.ldpc_resident_layered_decode(
        qv.data_ptr(), rcv.data_ptr(), bits.data_ptr(), iters.data_ptr(),
        conv.data_ptr(), *(t.data_ptr() for t in tables),
        nbt, layout.CG, layout.E, VG, Z, Bt, layout.max_chk_degree,
        int(max_iterations), BLOCK_THREADS,
        rule.big, rule.scale, _MSG_DTYPES[rule.storage_dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        msg = lib.ldpc_cuda_error_string(err).decode()
        raise RuntimeError(f"resident_layered_decode launch failed: {msg}")
    resident_layered_decode.launches += 1
    return bits, iters, conv


#: kernel launches since the count was last set to 0
resident_layered_decode.launches = 0


def resident_layered_decode_reference(
    qv0_t, bits0_t, layout, rule, max_iterations: int
):
    """The plain PyTorch version of ``resident_layered_decode``, on any
    device, same arguments and results. Tiles are independent, so it
    decodes them together; per-tile early exit changes no output."""
    nbt, VG, Z, Bt = qv0_t.shape

    def untile(x):
        return x.permute(1, 2, 0, 3).reshape(VG, Z, nbt * Bt)

    bits, iters, conv = layered_decode_planes(
        untile(qv0_t), untile(bits0_t) != 0, layout, rule, max_iterations
    )
    bits = bits.to(torch.int8).reshape(VG, Z, nbt, Bt).permute(2, 0, 1, 3)
    return (
        bits.contiguous(),
        iters.reshape(nbt, Bt),
        conv.to(torch.int32).reshape(nbt, Bt),
    )


def layered_decode_planes(qv0, hard0, layout, rule, max_iterations: int):
    """Plain layered decode of (VG, Z, N) planes.

    qv0: f32 posteriors init; hard0: bool raw-channel hard decisions;
    rule: ``layered_x(qv, rold)``, ``check(x)`` on (d, Z, N), ``big`` (the
    missing-lane poke) and ``storage_dtype`` (Rcv). Returns bits (VG, Z, N)
    bool, iterations (N,) int32 and success (N,) bool.
    """
    VG, Z, N = qv0.shape
    dev = qv0.device
    lane = torch.arange(Z, device=dev)
    vg = layout.syn_vg.to(device=dev, dtype=torch.long)
    rot = layout.syn_rot.to(device=dev, dtype=torch.long)
    # flat Qv row read by check lane c of edge e: var lane (c - s) mod Z
    src = vg[:, None] * Z + (lane[None, :] - rot[:, None]) % Z  # (E, Z)
    valid = (lane[None, :] != layout.syn_mask.to(dev)[:, None])[..., None]
    groups = [
        (m.ebase + j * m.d, m.d)
        for m in layout.chk_meta
        if m.d
        for j in range(m.g1 - m.g0)
    ]

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
    rcv = torch.zeros((layout.E, Z, N), dtype=rule.storage_dtype, device=dev)
    hard = hard0.reshape(VG * Z, N)
    conv = check_ok(hard)
    iters = torch.zeros(N, dtype=torch.int32, device=dev)
    frozen = hard
    it = 0
    while it < max_iterations and not bool(conv.all()):
        for e0, d in groups:
            idx = src[e0 : e0 + d]  # (d, Z)
            ok_lane = valid[e0 : e0 + d]
            rold = rcv[e0 : e0 + d].float()
            x = torch.where(ok_lane, rule.layered_x(qv[idx], rold), rule.big)
            rn = torch.where(ok_lane, rule.check(x), 0.0)
            delta = rn - rold  # before the store: rold may view rcv (f32)
            rcv[e0 : e0 + d] = rn.to(rule.storage_dtype)
            # in edge order: two edges into one variable group add in turn
            for t in range(d):
                qv[idx[t]] += delta[t]
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
