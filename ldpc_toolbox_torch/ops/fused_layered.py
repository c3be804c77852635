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

On a CUDA tensor it launches ``fused_layered_kernel`` of
``csrc/resident_layered.cu`` (one thread block per tile) or raises; on a
CPU tensor it runs the plain version
``fused_layered_iteration_reference``, which updates in place too.
"""

from __future__ import annotations

import torch

from .fused_bp2 import _MSG_DTYPES
from .resident_layered import (
    BLOCK_THREADS,
    _lib,
    layered_launch,
    message_sweep,
    plane_tables,
    raise_on,
)

__all__ = ["fused_layered_iteration", "fused_layered_iteration_reference"]


def fused_layered_iteration(qv_t, rcv_t, layout, rule):
    """One layered sweep in place: qv_t (nbt, VG, Z, Bt) f32 posteriors and
    rcv_t (nbt, E, Z, Bt) messages in the rule's storage type, both
    updated; returns (qv_t, rcv_t, bits (nbt, VG, Z, Bt) int8)."""
    if qv_t.device.type == "cpu":
        return fused_layered_iteration_reference(qv_t, rcv_t, layout, rule)
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
    lib = _lib()
    err = lib.ldpc_fused_layered_iteration(
        qv_t.data_ptr(), rcv_t.data_ptr(), bits.data_ptr(),
        None if park is None else park.data_ptr(), tables, *dims,
        BLOCK_THREADS, rule.big, rule.scale, _MSG_DTYPES[rule.storage_dtype],
        stream,
    )
    raise_on(lib, err, "fused_layered_iteration")
    fused_layered_iteration.launches += 1
    return qv_t, rcv_t, bits


#: kernel launches since the count was last set to 0
fused_layered_iteration.launches = 0


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
