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

The routing is ``takes_compressed_state``'s (its reason is there). All
forms give the same bits, iterations and success flags. On CPU tensors
every kernel wrapper runs its plain version, so the CPU runs the same
routing; ``flooding_loop`` stays the plain versions' own loop.

An arithmetic or a graph that the kernels do not take
(``lifted_layered.kernel_fallback``: no kernel rule, a check wider than
the rule's kernels take, a circulant missing more than one lane) decodes
on ``plane_flooding_decode``, the JAX package's plane-gather path
(``fused=False``): whole ``(Z, B)`` message planes a base edge, moved by
``ops/plane_gather.py``, and the arithmetic's own ``check_messages`` and
``var_update``, on either device. As in the JAX package, a graph beyond
a rule's kernels falls back with a warning naming the reason, an
arithmetic without a rule (one registered from outside the package)
silently. The route is chosen from the rule and the graph before
anything runs. The TPU's VMEM pickers and ``LDPC_FORCE_*`` switches have
no counterpart.
"""

from __future__ import annotations

import functools
import warnings
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fused_bp2 import (
    check_degree_cap,
    freeze_on_flags,
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
from ..ops.plane_gather import gather_planes, plane_index
from ..ops.resident_flooding import decode_loop, resident_flooding_decode
from ..telemetry import add, span
from .compaction import staged_while_decode
from .lifted import LiftedGraph
from .lifted_layered import (
    _planes_of,
    device_layout,
    kernel_fallback,
    pad_to_tiles,
    tile,
    tiles_to_output,
)

__all__ = [
    "flooding_tiles",
    "kernel_flooding_decode",
    "lifted_flooding_decode",
    "plane_flooding_decode",
    "plane_tables",
    "streaming_flooding_decode",
]


def lifted_flooding_decode(
    lg: LiftedGraph, arithmetic, llrs: torch.Tensor, max_iterations: int,
    resident: bool = True,
):
    """Decode a (B, n) batch of channel LLRs, flooding schedule, lifted
    layout. Returns a dict of tensors on the LLRs' device: ``codeword``
    (B, n) uint8, ``iterations`` (B,) int32, ``success`` (B,) bool. An
    arithmetic or graph the kernels do not take decodes on
    ``plane_flooding_decode``."""
    reason = kernel_fallback(lg, arithmetic)
    if reason is None:
        return kernel_flooding_decode(lg, arithmetic, llrs, max_iterations, resident)
    if rule_for(arithmetic) is not None:
        warnings.warn(
            f"the flooding kernels do not take this graph ({reason}); "
            "falling back to the plane-gather path",
            stacklevel=2,
        )
    return plane_flooding_decode(lg, arithmetic, llrs, max_iterations)


def kernel_flooding_decode(lg, arithmetic, llrs, max_iterations, resident=True):
    """``lifted_flooding_decode`` on the kernels, whatever
    ``kernel_fallback`` says: the route ``selftest`` holds against
    ``plane_flooding_decode``. Its spans and its tile count are
    ``kernel_layered_decode``'s."""
    with span("decode.tiles_in"):
        q_t, bits0_t, layout, rule = flooding_tiles(lg, arithmetic, llrs)
    if not resident:
        decode = streaming_flooding_decode
    elif takes_compressed_state(rule):
        decode = compressed_flooding_decode
    else:
        decode = resident_flooding_decode
    with span("decode.kernel"):
        bits, iters, conv = decode(q_t, bits0_t, layout, rule, max_iterations)
    if resident:
        add("tile_iterations", lambda: iters.amax(dim=1).sum())
    with span("decode.tiles_out"):
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


# -- the plane-gather path -----------------------------------------------------


@dataclass
class PlaneTables:
    """A lifted graph's plane-gather tables on one device.

    ``chk``: (groups, degree, message index, syndrome index, fixes) for each
    check bucket with groups and edges, in bucket order: the message index
    gathers its (G, d) v2c planes into check coordinates, the syndrome
    index its variable groups' bit planes; ``var``: (groups, degree,
    message index or None, fixes) for each variable bucket with groups, the
    index gathering its c2v planes into variable coordinates (None at
    degree 0). ``fixes`` are the missing lanes of incomplete circulants,
    (row, slot, lanes) of the bucket's gathered planes. ``var_sizes``: the
    group count of every variable bucket, for splitting the channel
    planes."""

    cols: torch.Tensor  # (VG * Z,) original column of each plane row
    inv: torch.Tensor  # (n,) plane row of each original column
    var_sizes: list
    chk: list
    var: list


#: (id(graph), device) -> PlaneTables, each dropped when its graph dies
_PLANE_TABLES: dict = {}


def _locate(buckets, position):
    """A flat edge position of one side -> (bucket index, row, slot)."""
    offset = 0
    for i, b in enumerate(buckets):
        size = len(b.groups) * b.degree
        if offset <= position < offset + size:
            return i, (position - offset) // b.degree, (position - offset) % b.degree
        offset += size
    raise ValueError(position)


def plane_tables(lg: LiftedGraph, device) -> PlaneTables:
    """The graph's plane-gather tables on a device, built and copied once
    per (graph, device)."""
    key = (id(lg), torch.device(device))
    tables = _PLANE_TABLES.get(key)
    if tables is not None:
        return tables
    Z = lg.Z
    chk_fix = {i: [] for i in range(len(lg.chk_buckets))}
    var_fix = {i: [] for i in range(len(lg.var_buckets))}
    for vm_posn, cm_posn, lanes_c, lanes_v in lg.missing:
        ib, row, slot = _locate(lg.chk_buckets, cm_posn)
        chk_fix[ib].append((row, slot, torch.as_tensor(np.asarray(lanes_c), device=device)))
        ib, row, slot = _locate(lg.var_buckets, vm_posn)
        var_fix[ib].append((row, slot, torch.as_tensor(np.asarray(lanes_v), device=device)))
    cols = lg.var_cols[lg.var_group_order].reshape(-1)
    inv = np.empty(lg.n, np.int64)
    inv[cols] = np.arange(lg.num_var_groups * Z)
    tables = _PLANE_TABLES[key] = PlaneTables(
        cols=torch.as_tensor(cols, device=device),
        inv=torch.as_tensor(inv, device=device),
        var_sizes=[len(b.groups) for b in lg.var_buckets],
        chk=[
            (len(b.groups), b.degree, plane_index(b.planes, b.shifts, Z, device),
             plane_index(b.var_group_pos, b.shifts, Z, device), chk_fix[i])
            for i, b in enumerate(lg.chk_buckets) if b.degree and len(b.groups)
        ],
        var=[
            (len(b.groups), b.degree,
             plane_index(b.planes, b.shifts, Z, device) if b.degree else None, var_fix[i])
            for i, b in enumerate(lg.var_buckets) if len(b.groups)
        ],
    )
    weakref.finalize(lg, _PLANE_TABLES.pop, key, None)
    return tables


def _fixed(planes, fixes, value):
    """The gathered (G, d, Z, B) ``planes`` with ``value`` in the missing
    lanes ``fixes``, in place."""
    for row, slot, lanes in fixes:
        planes[row, slot, lanes] = value
    return planes


def plane_flooding_decode(lg: LiftedGraph, arithmetic, llrs: torch.Tensor,
                          max_iterations: int):
    """The flooding decode on whole message planes, for any arithmetic:
    the JAX package's ``lifted_flooding_decode(fused=False)``. Messages
    are (E, Z, B) planes, v2c variable-major and c2v check-major; each
    phase gathers a bucket's planes into its own lane coordinates
    (``ops/plane_gather.py``), sets the missing lanes of incomplete
    circulants to a neutral value (the check side to +inf, 127 for an i8
    arithmetic; the variable side to 0), and runs the arithmetic's
    ``check_messages`` or ``var_update``. Iteration 0 tests the raw
    channel bits; then each iteration's posterior bits are tested and
    frozen (``ops/resident_flooding.decode_loop``: one host read an
    iteration). Returns the output of ``lifted_flooding_decode``."""
    t = plane_tables(lg, llrs.device)
    Z, B, VG = lg.Z, llrs.shape[0], lg.num_var_groups
    store, compute = arithmetic.storage_dtype, arithmetic.compute_dtype
    big = 127 if arithmetic.is_int8 else float("inf")

    llr_planes = llrs.T[t.cols].reshape(VG, Z, B)
    q_parts = [q for q, size in zip(arithmetic.quantize(llr_planes).split(t.var_sizes),
                                    t.var_sizes) if size]
    # the first v2c of each edge: its variable group's channel planes
    v2c = torch.cat([
        q.repeat_interleave(d, dim=0) for q, (_, d, _, _) in zip(q_parts, t.var) if d
    ]).to(store)

    def step():
        nonlocal v2c
        c2v = torch.cat([
            arithmetic.check_messages(
                _fixed(gather_planes(v2c, index, G, d).to(compute), fixes, big)
                .reshape(G, d, Z * B)
            ).reshape(G * d, Z, B).to(store)
            for G, d, index, _, fixes in t.chk
        ])
        v2c_parts, llr_parts = [], []
        for q, (G, d, index, fixes) in zip(q_parts, t.var):
            if d == 0:
                llr_parts.append(q)
                continue
            y = _fixed(gather_planes(c2v, index, G, d).to(compute), fixes, 0)
            v2c_b, llr_b = arithmetic.var_update(q.reshape(G, Z * B), y.reshape(G, d, Z * B))
            v2c_parts.append(v2c_b.reshape(G * d, Z, B).to(store))
            llr_parts.append(llr_b.reshape(G, Z, B))
        v2c = torch.cat(v2c_parts)
        return arithmetic.hard_decision(torch.cat(llr_parts)).view(1, VG, Z, B)

    def freeze(bits, frozen, conv, iters, it, counter):
        hard = bits.view(VG, Z, B).to(torch.int8)
        bad = torch.zeros(B, dtype=torch.bool, device=bits.device)
        for G, d, _, index, fixes in t.chk:
            g = _fixed(gather_planes(hard, index, G, d), fixes, 0)
            bad |= ((g.sum(dim=1, dtype=torch.int32) & 1) != 0).flatten(0, 1).any(dim=0)
        freeze_on_flags(bad.to(torch.int32)[None], bits, frozen, conv, iters, it, counter)

    bits0 = (llr_planes <= 0).view(1, VG, Z, B)
    bits, iters, conv = decode_loop(bits0, bits0, step, freeze, max_iterations)
    return {
        "codeword": bits.view(VG * Z, B)[t.inv].T.to(torch.uint8),
        "iterations": iters.view(B),
        "success": conv.view(B).to(torch.bool),
    }
