"""Flooding BP on the block-circulant (lifted) layout.

Counterpart of the JAX package's ``decoder.lifted_flooding`` fused path
(``_fused_flooding_decode``): the batch is cut into tiles of BT frames
(the last padded with +100-LLR frames), the channel LLRs are cast to the
message storage type before they are gathered into ``(VG, Z, B)`` planes
(so for the bf16 names the channel planes and the iteration-0 bits come
from bf16 values, for the f64 names from f64 values; the i8 names gather f32 planes, quantize them to int8
and take the iteration-0 bits from the f32 planes), and the decoded
planes are put back into codeword order. The tiles then go through one of
three forms, as the JAX package's ``_fused_flooding_decode`` does at the
flagship shape:

* ``resident=True`` (the default), f32 storage (``Minsumf32``,
  ``Normminsumf32``): ``ops/resident_compressed.compressed_flooding_decode``,
  the whole decode in one launch with the check state compressed;
* ``resident=True``, bf16 storage, the i8 names and the float names
  (Phi, Tanh, Minstarapprox, Aminstar in f32 and f64):
  ``ops/resident_flooding.py``, the whole decode in one launch with v2c
  and c2v messages;
* ``resident=False``, every name: the streaming phases of
  ``ops/fused_bp2.py`` (``fused_var`` initialisation, then ``fused_check``,
  ``fused_var`` and ``fused_syndrome_freeze`` an iteration, the phases on
  the rule's instances; the last the syndrome kernel, which also freezes
  the frames that pass and counts those left) under
  ``decoder/compaction.staged_while_decode``, as the JAX package's
  ``resident=False`` path does.

A check wider than the rule's kernels take raises a ValueError on every
device (``check_degree_cap``).

The routing is ``takes_compressed_state``'s (its reason is there). All
forms give the same bits, iterations and success flags. On CPU
tensors every kernel wrapper runs its plain version, so the CPU runs the
same routing; ``flooding_loop`` stays the plain versions' own loop.

Not ported yet (ROADMAP A7): the plane-gather path that serves rules
without a kernel. The TPU's VMEM pickers and ``LDPC_FORCE_*`` switches
have no counterpart.
"""

from __future__ import annotations

import functools

import torch

from ..ops.fused_bp2 import (
    check_degree_cap,
    fused_check,
    fused_syndrome_freeze,
    fused_var,
    is_i8,
    rule_for,
)
from ..ops.resident_compressed import (
    compressed_flooding_decode,
    takes_compressed_state,
)
from ..ops.resident_flooding import resident_flooding_decode
from .compaction import staged_while_decode
from .lifted import LiftedGraph
from .lifted_layered import (
    _planes_of,
    device_layout,
    pad_to_tiles,
    tile,
    tiles_to_output,
)

__all__ = ["lifted_flooding_decode", "flooding_tiles", "streaming_flooding_decode"]


def lifted_flooding_decode(
    lg: LiftedGraph, arithmetic, llrs: torch.Tensor, max_iterations: int,
    resident: bool = True,
):
    """Decode a (B, n) batch of channel LLRs, flooding schedule, lifted
    layout. Returns a dict of tensors on the LLRs' device: ``codeword``
    (B, n) uint8, ``iterations`` (B,) int32, ``success`` (B,) bool."""
    q_t, bits0_t, layout, rule = flooding_tiles(lg, arithmetic, llrs)
    if not resident:
        decode = streaming_flooding_decode
    elif takes_compressed_state(rule):
        decode = compressed_flooding_decode
    else:
        decode = resident_flooding_decode
    bits, iters, conv = decode(q_t, bits0_t, layout, rule, max_iterations)
    return tiles_to_output(lg, bits, iters, conv, llrs.shape[0])


def flooding_tiles(lg, arithmetic, llrs):
    """The kernels' inputs for a (B, n) batch of LLRs: the channel planes
    in the storage type and their hard bits as (nbt, VG, Z, BT) tiles, the
    device layout and the rule."""
    rule = rule_for(arithmetic)
    if rule is None:
        raise NotImplementedError(f"{type(arithmetic).__name__} has no kernel rule")
    layout = device_layout(lg, llrs.device)
    check_degree_cap(layout, rule)
    llrs = pad_to_tiles(llrs)
    if is_i8(rule):
        # gather in f32, then quantize; the raw bits come from the f32
        # planes (a tiny positive LLR quantizes to 0)
        planes, _ = _planes_of(lg, llrs)
        q = arithmetic.quantize(planes).to(torch.int8)
    else:
        # cast before the gather, as the JAX package does (f32 -> f64 is
        # exact)
        planes, _ = _planes_of(lg, llrs, rule.storage_dtype)
        q = planes
    return tile(q), tile((planes <= 0).to(torch.int8)), layout, rule


def streaming_flooding_decode(q_t, bits0_t, layout, rule, max_iterations):
    """The flooding decode through the three phase kernels under staged
    compaction; the arguments and results of ``resident_flooding_decode``."""

    def iteration(state, const):
        c2v = fused_check(state[0], layout, rule)
        v2c, bits = fused_var(c2v, const[0], layout, rule)
        return (v2c,), bits

    return staged_while_decode(
        max_iterations=max_iterations,
        state=(fused_var(None, q_t, layout, rule)[0],),
        const=(q_t,),
        bits0=bits0_t,
        iteration=iteration,
        freeze=functools.partial(fused_syndrome_freeze, layout=layout),
    )
