"""Horizontal-layered BP on the block-circulant (lifted) layout.

Counterpart of ``ldpc_toolbox_tpu.decoder.lifted_layered``. A layer is one
check group: Z structurally parallel checks, each touching a distinct lane
of each incident variable group, except where a group holds two base edges
into the same variable group (DVB-S2, CCSDS C2); those deltas add against
the layer-entry Qv in edge order. Layer order is check-bucket-major (the
flat layout's group order), not the reference's 0..m row sweep.

``lifted_layered_decode`` cuts the batch into tiles of BT frames (the last
padded with +100-LLR frames) and runs one of three forms, as the JAX
package's ``_fused_layered_decode`` does at the flagship shape:

* ``resident=True`` (the default), f32 Rcv storage (``HLMinsumf32``,
  ``HLNormminsumf32``): ``ops/resident_compressed.compressed_layered_decode``,
  the whole decode in one launch with the check state compressed;
* ``resident=True``, bf16 storage, the i8 names and the float names
  (Phi, Tanh, Minstarapprox, Aminstar in f32 and f64):
  ``ops/resident_layered.py``, the whole decode in one launch with Rcv
  messages (int8 Rcv and int16 Qv for i8, f64 both for the f64 names);
* ``resident=False``, every name: the streaming form,
  ``ops/fused_layered.py``'s sweep (on the rule's instances, with int16 Qv
  for the i8 names and f64 Qv for the f64 names) and
  ``fused_syndrome_freeze`` (the syndrome kernel, which also freezes the
  frames that pass and counts those left) one launch each an iteration,
  under ``decoder/compaction.staged_while_decode``.

The routing is ``takes_compressed_state``'s (its reason is there). All
forms give the same bits, iterations and success flags. On
CPU tensors every kernel wrapper runs its plain version, so the CPU runs
the same routing.

``plain_layered_decode`` is the twin of the JAX package's jnp path, for
any arithmetic. ``lifted_layered_decode`` takes it, silently as the JAX
package does, when the kernels do not take the arithmetic or the graph
(``kernel_fallback``: no kernel rule, a check wider than the rule's
kernels take, or a circulant missing more than one lane). The route is
chosen from the rule and the graph before anything runs; the kernel
wrappers still refuse what they do not take (``check_degree_cap``).
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from ..convert import layout_to_device
from ..ops.fused_bp2 import (
    BT,
    build_fused_layout,
    check_degree_cap,
    fused_syndrome_freeze,
    rule_for,
)
from ..ops.fused_layered import fused_layered_iteration
from ..ops.resident_compressed import (
    compressed_layered_decode,
    takes_compressed_state,
)
from ..ops.resident_layered import (
    layered_decode_planes,
    resident_layered_decode,
)
from .compaction import staged_while_decode
from .lifted import LiftedGraph

__all__ = [
    "device_layout",
    "kernel_fallback",
    "kernel_layered_decode",
    "lifted_layered_decode",
    "pad_to_tiles",
    "plain_layered_decode",
    "streaming_layered_decode",
    "tile",
    "tile_inputs",
    "tiles_to_output",
]


def lifted_layered_decode(
    lg: LiftedGraph, arithmetic, llrs: torch.Tensor, max_iterations: int,
    resident: bool = True,
):
    """Decode a (B, n) batch of channel LLRs, layered schedule, lifted
    layout. Returns a dict of tensors on the LLRs' device: ``codeword``
    (B, n) uint8, ``iterations`` (B,) int32, ``success`` (B,) bool. An
    arithmetic or graph the kernels do not take (``kernel_fallback``)
    decodes on ``plain_layered_decode``."""
    if kernel_fallback(lg, arithmetic) is not None:
        return plain_layered_decode(lg, arithmetic, llrs, max_iterations)
    return kernel_layered_decode(lg, arithmetic, llrs, max_iterations, resident)


def kernel_fallback(lg: LiftedGraph, arithmetic):
    """Why the kernels do not take this arithmetic on this graph, or None
    when they do: the arithmetic has no kernel rule (``rule_for``), a
    check is wider than the rule's kernels take (``max_check_degree``), or
    a circulant misses more than one lane (``build_fused_layout`` takes
    one). The JAX package falls back on the same conditions; its variable
    degree cap has no counterpart, because the port's kernels loop over a
    variable's edges, whatever their number."""
    rule = rule_for(arithmetic)
    if rule is None:
        return f"{type(arithmetic).__name__} has no kernel rule"
    if any(len(lanes) != 1 for _, _, lanes, _ in lg.missing):
        return "a circulant misses more than one lane"
    dmax = max((b.degree for b in lg.chk_buckets if len(b.groups)), default=0)
    if dmax > rule.max_check_degree:
        return (f"check degree {dmax} above {rule.max_check_degree}, the most the "
                f"kernels of {type(rule).__name__} take")
    return None


def kernel_layered_decode(lg, arithmetic, llrs, max_iterations, resident=True):
    """``lifted_layered_decode`` on the kernels, whatever
    ``kernel_fallback`` says: the route ``selftest`` holds against
    ``plain_layered_decode``."""
    qv0_t, bits0_t, layout, rule = tile_inputs(lg, arithmetic, llrs)
    if not resident:
        decode = streaming_layered_decode
    elif takes_compressed_state(rule):
        decode = compressed_layered_decode
    else:
        decode = resident_layered_decode
    bits, iters, conv = decode(qv0_t, bits0_t, layout, rule, max_iterations)
    return tiles_to_output(lg, bits, iters, conv, llrs.shape[0])


#: (id(graph), device) -> DeviceLayout, each dropped when its graph dies
_LAYOUTS: dict = {}


def device_layout(lg, device):
    """The graph's decode tables on a device, built and copied once per
    (graph, device): they depend only on the code."""
    key = (id(lg), torch.device(device))
    layout = _LAYOUTS.get(key)
    if layout is None:
        layout = _LAYOUTS[key] = layout_to_device(build_fused_layout(lg), device)
        weakref.finalize(lg, _LAYOUTS.pop, key, None)
    return layout


def _planes_of(lg, llrs, dtype=torch.float32):
    """Channel LLRs cast to ``dtype``, then gathered into (VG, Z, B)
    planes in var-bucket group order."""
    col_of = lg.var_cols[lg.var_group_order]
    idx = torch.as_tensor(col_of.reshape(-1), device=llrs.device)
    planes = llrs.to(dtype).T[idx].reshape(
        lg.num_var_groups, lg.Z, llrs.shape[0]
    )
    return planes, col_of


def _codeword_from_planes(lg, col_of, hard_planes):
    VG, Z = lg.num_var_groups, lg.Z
    inv = np.empty(lg.n, np.int64)
    inv[col_of.reshape(-1)] = np.arange(VG * Z)
    B = hard_planes.shape[-1]
    idx = torch.as_tensor(inv, device=hard_planes.device)
    return hard_planes.reshape(VG * Z, B)[idx].T.to(torch.uint8)


class _ArithmeticRule:
    """The jnp path's view of an arithmetic for ``layered_decode_planes``:
    its own check rule on one layer, and +inf in the missing lanes (127
    for an i8 arithmetic)."""

    def __init__(self, arithmetic):
        self.arithmetic = arithmetic
        self.storage_dtype = arithmetic.storage_dtype
        self.compute_dtype = arithmetic.compute_dtype
        self.big = 127 if arithmetic.is_int8 else float("inf")

    def layered_x(self, qv, rold):
        return self.arithmetic.layered_x(qv, rold)

    def check(self, x):
        d = x.shape[0]
        out = self.arithmetic.check_messages(x.reshape(1, d, -1))
        return out.reshape(x.shape)


def plain_layered_decode(lg, arithmetic, llrs, max_iterations):
    """The layered decode in torch ops on whole planes, for any arithmetic
    (the JAX package's jnp path); the output of ``lifted_layered_decode``."""
    layout = device_layout(lg, llrs.device)
    llr_planes, col_of = _planes_of(lg, llrs)
    q = arithmetic.quantize(llr_planes)
    qv0 = arithmetic.llr_to_var_llr(q).to(arithmetic.var_llr_storage_dtype)
    bits, iters, conv = layered_decode_planes(
        qv0, llr_planes <= 0, layout, _ArithmeticRule(arithmetic),
        max_iterations,
    )
    return {
        "codeword": _codeword_from_planes(lg, col_of, bits),
        "iterations": iters,
        "success": conv,
    }


def pad_to_tiles(llrs):
    """(B, n) LLRs padded to a whole number of BT-frame tiles with +100-LLR
    frames: the all-zero codeword satisfies every check at iteration 0, so
    pad frames converge at once and never hold a tile open."""
    if llrs.shape[0] % BT:
        pad = llrs.new_full((BT - llrs.shape[0] % BT, llrs.shape[1]), 100.0)
        llrs = torch.cat([llrs, pad])
    return llrs


def tile(x):
    """(P, Z, B) planes -> (nbt, P, Z, BT) tiles, frames innermost."""
    P, Z, B = x.shape
    return x.reshape(P, Z, B // BT, BT).permute(2, 0, 1, 3).contiguous()


def tiles_to_output(lg, bits, iters, conv, batch):
    """A kernel's (bits, iters, conv) tiles -> the decoder's output dict
    for the first ``batch`` frames."""
    nbt, VG, Z, Bt = bits.shape
    planes = bits.permute(1, 2, 0, 3).reshape(VG, Z, nbt * Bt)
    col_of = lg.var_cols[lg.var_group_order]
    return {
        "codeword": _codeword_from_planes(lg, col_of, planes)[:batch],
        "iterations": iters.reshape(-1)[:batch],
        "success": (conv.reshape(-1) != 0)[:batch],
    }


def tile_inputs(lg, arithmetic, llrs):
    """The kernel's inputs for a (B, n) batch of LLRs: qv0 and raw-channel
    bits as (nbt, VG, Z, BT) tiles (a partial last tile padded by
    ``pad_to_tiles``), the device layout and the rule."""
    rule = rule_for(arithmetic)
    if rule is None:
        raise NotImplementedError(f"{type(arithmetic).__name__} has no kernel rule")
    layout = device_layout(lg, llrs.device)
    check_degree_cap(layout, rule)
    # f32 planes, then the posteriors' storage type (f64 for an f64 rule),
    # as the JAX package does
    llr_planes, _ = _planes_of(lg, pad_to_tiles(llrs))
    q = arithmetic.quantize(llr_planes)
    qv0 = arithmetic.llr_to_var_llr(q).to(arithmetic.var_llr_storage_dtype)
    return tile(qv0), tile((llr_planes <= 0).to(torch.int8)), layout, rule


def streaming_layered_decode(qv0_t, bits0_t, layout, rule, max_iterations):
    """The layered decode one sweep a launch (``fused_layered_iteration``,
    then ``fused_syndrome_freeze``) under staged compaction; the arguments
    and results of ``resident_layered_decode``."""
    nbt, _, Z, Bt = qv0_t.shape
    rcv = torch.zeros(
        (nbt, layout.E, Z, Bt), dtype=rule.storage_dtype, device=qv0_t.device
    )

    def iteration(state, const):
        qv, rcv, bits = fused_layered_iteration(*state, layout, rule)
        return (qv, rcv), bits

    return staged_while_decode(
        max_iterations=max_iterations,
        state=(qv0_t.clone(memory_format=torch.contiguous_format), rcv),
        const=(),
        bits0=bits0_t,
        iteration=iteration,
        freeze=functools.partial(fused_syndrome_freeze, layout=layout),
    )
