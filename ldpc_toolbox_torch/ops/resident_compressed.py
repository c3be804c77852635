"""Whole min-sum decodes of frame tiles with the check state compressed.

Counterpart of the JAX package's ``ops/resident_compressed.py``. Min-sum's
check outputs are determined by four quantities a check: the signs of its
outputs, the smallest and second-smallest input magnitude and the slot of
the smallest. So the state of a decode compresses losslessly:

* ``compressed_layered_decode`` (the contract of ``resident_layered_decode``)
  keeps Qv f32, ``ssign`` int8 (E, Z, Bt) with values in {-2, -1, 0, 1, 2}
  (|sigma| = 2 marks the argmin slot, 0 the missing lane) and ``min1``,
  ``min2`` (CG, Z, Bt) in the storage type, post-scale. It rebuilds
  ``Rold = w1 * min1 + w2 * min2`` with ``w2 = sigma - clip(sigma, -1, 1)``
  and ``w1 = sigma - 2 * w2``; the Qv delta uses the pre-cast f32 Rnew.
* ``compressed_flooding_decode`` (the contract of
  ``resident_flooding_decode``) keeps ``s`` f32 (VG, Z, Bt), the posterior
  totals, ``ssign`` int8 (E, Z, Bt) with each edge's c2v sign (0 at the
  missing lane), and ``min1``, ``min2`` (storage type) and ``argm`` int8
  (CG, Z, Bt). The check phase rebuilds v2c as ``store(roll(s) - c2v_old)``
  with big at the missing lane; the variable phase sums ``q + sum
  roll(c2v)`` in the streaming var-major slot order through the layout's
  ``rec_*`` tables; the syndrome reads ``s <= 0``.

Both give the bits, iterations and success flags of the message kernels
(the sign of some zeros differs inside, which nothing downstream sees).
The decoders send the f32 min-sum names here (``takes_compressed_state``). On a
CUDA tensor each wrapper launches its kernel of ``csrc/compressed.cu`` or
raises; on a CPU tensor it runs its plain version, which keeps the same
compressed state and rebuilds messages from it as the kernel does. The
kernels give a thread all four frames of a lane, so they take tiles of
exactly 4 frames and raise on any other width; the plain versions
take any width.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fused_bp2 import (
    _MSG_DTYPES,
    MinSumRule,
    _roll_planes,
    fused_syndrome_freeze_reference,
)
from .resident_flooding import decode_loop
from .resident_layered import (
    LANE_THREADS,
    check_bits,
    lane_launch,
    layered_loop,
    on_planes,
    plane_tables,
    shared_ints,
)

__all__ = [
    "compressed_flooding_decode",
    "compressed_flooding_decode_reference",
    "compressed_layered_decode",
    "compressed_layered_decode_reference",
    "shared_ints",
    "takes_compressed_state",
]

def takes_compressed_state(rule) -> bool:
    """Whether the resident decodes of a rule keep the compressed check
    state: the f32 min-sum names do; the bf16 ones and every other rule
    (the i8 rules) keep messages. The compressed state holds min-sum's
    check outputs only, so no rule but ``MinSumRule`` may reach it (the
    JAX package's ``isinstance(rule, MinSumRule)``).

    This reproduces the JAX package's choice at the flagship shape (DVB-S2
    R1_2) for all four min-sum combinations of schedule and storage type,
    so each TPU kernel's counterpart carries the names it carried there.
    Its grounds on the TPU (the f32 message state did not fit the vector
    memory) do not hold on this card, where every form keeps its state in
    device memory; the card's measurements of both forms stand in PERF.md
    and a benchmark cell is to settle the rule."""
    return isinstance(rule, MinSumRule) and rule.storage_dtype == torch.float32


def _require_min_sum(rule) -> None:
    if not isinstance(rule, MinSumRule):
        raise TypeError(
            f"the compressed kernels carry min-sum only, not {type(rule).__name__}"
        )


@functools.cache
def _lib():
    return bind(_build.load("compressed"))


def bind(lib):
    """Declares the C interface of a library built from
    ``csrc/compressed.cu``; returns it."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_compressed_layered_decode.argtypes = (
        [p] * 9 + [i] * 7 + [i, i, f, f, i, p]
    )
    lib.ldpc_compressed_flooding_decode.argtypes = (
        [p] * 10 + [i] * 7 + [i, i, f, f, i, p]
    )
    for fn in (lib.ldpc_compressed_layered_decode,
               lib.ldpc_compressed_flooding_decode):
        fn.restype = i
    lib.ldpc_compressed_error_string.argtypes = [i]
    lib.ldpc_compressed_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _lib().ldpc_compressed_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


def _state(nbt, layout, Z, Bt, store, dev):
    """Zeroed (ssign, min1, min2): sigma = 0 rebuilds every message as 0."""
    return (
        torch.zeros((nbt, layout.E, Z, Bt), dtype=torch.int8, device=dev),
        torch.zeros((nbt, layout.CG, Z, Bt), dtype=store, device=dev),
        torch.zeros((nbt, layout.CG, Z, Bt), dtype=store, device=dev),
    )


def compressed_layered_decode(qv0_t, bits0_t, layout, rule, max_iterations: int):
    """(qv0, bits0) -> (bits, iters, conv) for every tile, the arguments
    and results of ``resident_layered_decode``."""
    if qv0_t.device.type == "cpu":
        return compressed_layered_decode_reference(
            qv0_t, bits0_t, layout, rule, max_iterations
        )
    _require_min_sum(rule)
    qv = qv0_t.clone(memory_format=torch.contiguous_format)
    check_bits(bits0_t, qv)
    if qv.dtype != torch.float32:
        raise TypeError("qv0_t must be float32")
    tables, dims, park, stream = lane_launch(qv, layout, rule, max_iterations, True)
    nbt, _, Z, Bt = qv.shape
    dev = qv.device
    ssign, min1, min2 = _state(nbt, layout, Z, Bt, rule.storage_dtype, dev)
    bits = bits0_t.clone(memory_format=torch.contiguous_format)
    iters = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    conv = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    _raise_on(
        _lib().ldpc_compressed_layered_decode(
            qv.data_ptr(), ssign.data_ptr(), min1.data_ptr(), min2.data_ptr(),
            bits.data_ptr(), iters.data_ptr(), conv.data_ptr(),
            None if park is None else park.data_ptr(), tables, *dims,
            int(max_iterations), LANE_THREADS, rule.big, rule.scale,
            _MSG_DTYPES[rule.storage_dtype], stream,
        ),
        "compressed_layered_decode",
    )
    compressed_layered_decode.launches += 1
    return bits, iters, conv


def compressed_flooding_decode(q_t, bits0_t, layout, rule, max_iterations: int):
    """(q, bits0) -> (bits, iters, conv) for every tile, the arguments and
    results of ``resident_flooding_decode``: q_t (nbt, VG, Z, Bt) channel
    planes in the rule's storage type."""
    if q_t.device.type == "cpu":
        return compressed_flooding_decode_reference(
            q_t, bits0_t, layout, rule, max_iterations
        )
    _require_min_sum(rule)
    if q_t.dtype != rule.storage_dtype or not q_t.is_contiguous():
        raise TypeError(f"q_t must be contiguous {rule.storage_dtype}")
    nbt, VG, Z, Bt = q_t.shape
    s = torch.empty((nbt, VG, Z, Bt), dtype=torch.float32, device=q_t.device)
    check_bits(bits0_t, s)
    if q_t.data_ptr() % 16:
        raise ValueError("q_t must start on a 16-byte boundary")
    tables, dims, _, stream = lane_launch(s, layout, rule, max_iterations, False)
    dev = q_t.device
    ssign, min1, min2 = _state(nbt, layout, Z, Bt, rule.storage_dtype, dev)
    argm = torch.zeros((nbt, layout.CG, Z, Bt), dtype=torch.int8, device=dev)
    bits = bits0_t.clone(memory_format=torch.contiguous_format)
    iters = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    conv = torch.empty((nbt, Bt), dtype=torch.int32, device=dev)
    _raise_on(
        _lib().ldpc_compressed_flooding_decode(
            s.data_ptr(), q_t.data_ptr(), ssign.data_ptr(), min1.data_ptr(),
            min2.data_ptr(), argm.data_ptr(), bits.data_ptr(), iters.data_ptr(),
            conv.data_ptr(), tables, *dims, int(max_iterations),
            LANE_THREADS, rule.big, rule.scale,
            _MSG_DTYPES[rule.storage_dtype], stream,
        ),
        "compressed_flooding_decode",
    )
    compressed_flooding_decode.launches += 1
    return bits, iters, conv


#: kernel launches since the count was last set to 0
compressed_layered_decode.launches = 0
compressed_flooding_decode.launches = 0


def _scaled(m, rule):
    return m * rule.scale if rule.scale != 1.0 else m


def compressed_layered_decode_reference(
    qv0_t, bits0_t, layout, rule, max_iterations: int
):
    """The plain PyTorch version of ``compressed_layered_decode``, on any
    device, same arguments and results."""
    return on_planes(_compressed_layered_planes, qv0_t, bits0_t, layout, rule,
                     max_iterations)


def _compressed_layered_planes(qv0, hard0, layout, rule, max_iterations):
    _, Z, N = qv0.shape
    dev = qv0.device
    tables = plane_tables(layout, dev)
    src, valid, groups = tables
    ssign = torch.zeros((layout.E, Z, N), dtype=torch.int8, device=dev)
    min1 = torch.zeros((layout.CG, Z, N), dtype=rule.storage_dtype, device=dev)
    min2 = torch.zeros_like(min1)

    def sweep(qv):
        for g, e0, d in groups:
            idx = src[e0 : e0 + d]  # (d, Z)
            ok = valid[e0 : e0 + d]
            sigma = ssign[e0 : e0 + d].to(torch.int32)
            w2 = sigma - sigma.clamp(-1, 1)
            w1 = sigma - 2 * w2
            rold = w1.float() * min1[g].float() + w2.float() * min2[g].float()
            x = torch.where(ok, qv[idx] - rold, rule.big)
            m1, m2, arg, par, negs = rule.fold(x)
            m1, m2 = _scaled(m1, rule), _scaled(m2, rule)
            isarg = arg == torch.arange(d, device=dev)[:, None, None]
            sgn = torch.where(ok, 1 - 2 * (par ^ torch.stack(negs)).to(torch.int32), 0)
            rnew = sgn.float() * torch.where(isarg, m2, m1)
            delta = rnew - rold
            # in edge order: two edges into one variable group add in turn
            for t in range(d):
                qv[idx[t]] += delta[t]
            ssign[e0 : e0 + d] = (sgn * torch.where(isarg, 2, 1)).to(torch.int8)
            min1[g] = m1.to(rule.storage_dtype)
            min2[g] = m2.to(rule.storage_dtype)

    return layered_loop(qv0, hard0, layout, max_iterations, tables, sweep)


def compressed_flooding_decode_reference(
    q_t, bits0_t, layout, rule, max_iterations: int
):
    """The plain PyTorch version of ``compressed_flooding_decode``, on any
    device, same arguments and results. Tiles are independent, so it
    decodes them together and stops when every frame has converged."""
    nbt, VG, Z, Bt = q_t.shape
    dev = q_t.device
    store = rule.storage_dtype
    q = q_t.float()
    s = q.clone()
    ssign, min1, min2 = _state(nbt, layout, Z, Bt, store, dev)
    argm = torch.zeros((nbt, layout.CG, Z, Bt), dtype=torch.int8, device=dev)
    lane = torch.arange(Z, device=dev)
    missing = lane[None, :, None] == layout.syn_mask.to(dev).long()[:, None, None]

    def recon(planes, groups, slots):
        """f32 c2v of check-major edges ``planes`` (check coordinates): its
        sign times the group's min2 at its slot's argmin, min1 elsewhere."""
        sel = torch.where(
            argm[:, groups].long() == slots[None, :, None, None],
            min2[:, groups].float(), min1[:, groups].float(),
        )
        return ssign[:, planes].float() * sel

    def check_phase():
        for m in layout.chk_meta:
            if not m.d:
                continue
            G = m.g1 - m.g0
            e0, e1 = m.ebase, m.ebase + G * m.d
            grp = torch.arange(m.g0, m.g1, device=dev).repeat_interleave(m.d)
            slot = torch.arange(m.d, device=dev).repeat(G)
            qc = _roll_planes(s[:, layout.syn_vg[e0:e1].long()], layout.syn_rot[e0:e1])
            x = (qc - recon(torch.arange(e0, e1, device=dev), grp, slot)).to(store)
            x = torch.where(missing[e0:e1], rule.big, x.float())
            x = x.reshape(nbt, G, m.d, Z, Bt)
            m1, m2, arg, par, negs = rule.fold([x[:, :, t] for t in range(m.d)])
            sg = 1 - 2 * (par[:, :, None] ^ torch.stack(negs, dim=2)).to(torch.int8)
            sg = sg.reshape(nbt, G * m.d, Z, Bt)
            ssign[:, e0:e1] = torch.where(missing[e0:e1], 0, sg).to(torch.int8)
            min1[:, m.g0 : m.g1] = _scaled(m1, rule).to(store)
            min2[:, m.g0 : m.g1] = _scaled(m2, rule).to(store)
            argm[:, m.g0 : m.g1] = arg.to(torch.int8)

    def var_phase():
        for m in layout.var_meta:
            G = m.g1 - m.g0
            tot = q[:, m.g0 : m.g1]
            if m.d:
                p0, p1 = m.ebase, m.ebase + G * m.d
                y = recon(
                    layout.rec_plane[p0:p1].long(), layout.rec_group[p0:p1].long(),
                    layout.rec_slot[p0:p1].long(),
                )
                y = _roll_planes(y, layout.rec_rot[p0:p1]).reshape(nbt, G, m.d, Z, Bt)
                for t in range(m.d):  # in slot order, as the kernels sum
                    tot = tot + y[:, :, t]
            s[:, m.g0 : m.g1] = tot

    def step():
        check_phase()
        var_phase()
        return (s <= 0).to(torch.int8)

    return decode_loop(
        bits0_t, (s <= 0).to(torch.int8), step,
        functools.partial(fused_syndrome_freeze_reference, layout=layout), max_iterations,
    )
