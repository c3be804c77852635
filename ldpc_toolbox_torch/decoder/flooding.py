"""Flooding-schedule belief propagation on a generic parity-check matrix.

Counterpart of ``ldpc_toolbox_tpu.decoder.flooding`` (the reference's
``decoder/flooding.rs``): one iteration is all check nodes, then all
variable nodes, with per-frame early exit. The messages use the compact
bucketed layout of ``decoder/layout.DecodeGraph``: variables and checks
reordered by degree, v2c and c2v in exact ``(num_edges, batch)`` arrays
(v2c variable-major, c2v check-major), and each phase one gather and the
arithmetic's unmasked rule a degree bucket. Iteration 0 tests the raw
channel bits; then each iteration's posterior hard bits are tested and
frozen by ``ops/fused_bp2.freeze_on_flags`` under
``ops/resident_flooding.decode_loop``, which reads the device once an
iteration (the count of frames left) and stops when every frame has
passed or after ``max_iterations``.

These are torch ops, not hand-written kernels: the JAX path is plain
``jnp`` gathers (no Pallas kernel), and the card runs the same ops on CUDA
tensors. The device tables are built once per (graph, device)
(``device_tables``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fused_bp2 import freeze_on_flags
from ..ops.resident_flooding import decode_loop
from .layout import DecodeGraph

__all__ = ["FloodingTables", "device_tables", "flooding_decode"]


@dataclass
class FloodingTables:
    """A DecodeGraph's compact bucketed layout on one device.

    ``var_buckets``: (count, degree, c2v edge ids (count * degree,)) per
    variable bucket, in bucket order (a degree-0 bucket's ids are empty);
    ``chk_buckets``: (count, degree, v2c edge ids, bucket-order variable
    ids, both (count * degree,)) per check bucket of degree > 0."""

    var_order: torch.Tensor  # (n,) original variable per bucket position
    inv_var_order: torch.Tensor  # (n,) bucket position per original variable
    var_buckets: list
    chk_buckets: list


#: (id(graph), device) -> FloodingTables, each dropped when its graph dies
_TABLES: dict = {}


def device_tables(graph: DecodeGraph, device) -> FloodingTables:
    """The graph's flooding tables on a device, built and copied once per
    (graph, device)."""
    key = (id(graph), torch.device(device))
    tables = _TABLES.get(key)
    if tables is None:
        def on(a):
            return torch.as_tensor(np.asarray(a, np.int64).reshape(-1), device=device)

        tables = _TABLES[key] = FloodingTables(
            var_order=on(graph.var_order),
            inv_var_order=on(graph.inv_var_order),
            var_buckets=[(len(b.ids), b.degree, on(b.edges))
                         for b in graph.var_buckets if len(b.ids)],
            chk_buckets=[(len(b.ids), b.degree, on(b.edges), on(b.vars))
                         for b in graph.chk_buckets if b.degree and len(b.ids)],
        )
        weakref.finalize(graph, _TABLES.pop, key, None)
    return tables


def syndrome_flags(chk_buckets, hard):
    """(1, B) int32, nonzero where a frame of ``hard`` ((n, B) bits in
    bucket order) leaves a check unsatisfied."""
    bits = hard.to(torch.int32)
    bad = torch.zeros(hard.shape[1], dtype=torch.bool, device=hard.device)
    for count, degree, _, vars_ in chk_buckets:
        g = bits[vars_].view(count, degree, -1)
        bad |= ((g.sum(dim=1, dtype=torch.int32) & 1) != 0).any(dim=0)
    return bad.to(torch.int32)[None]


def flooding_decode(graph: DecodeGraph, arithmetic, llrs, max_iterations: int):
    """Decode a batch of LLR frames on their device.

    Args:
      graph: the code's DecodeGraph.
      arithmetic: an ``Arithmetic`` instance.
      llrs: (B, n) float channel LLRs (positive -> bit 0).
      max_iterations: iteration cap.

    Returns:
      dict with ``codeword`` (B, n) uint8, ``iterations`` (B,) int32,
      ``success`` (B,) bool.
    """
    t = device_tables(graph, llrs.device)
    n = graph.n
    llr_t = llrs.T[t.var_order]  # (n, B), bucket order
    B = llr_t.shape[1]
    store = arithmetic.storage_dtype
    compute = arithmetic.compute_dtype

    hard0 = llr_t <= 0
    q = arithmetic.quantize(llr_t)
    q_parts = q.split([count for count, _, _ in t.var_buckets])
    # the first variable messages are the channel LLRs (flooding.rs:93-99)
    v2c = torch.cat([
        qp.repeat_interleave(degree, dim=0)
        for qp, (_, degree, _) in zip(q_parts, t.var_buckets) if degree
    ]).to(store)

    def step():
        nonlocal v2c
        c2v = torch.cat([
            arithmetic.check_messages(
                v2c[edges].view(count, degree, B).to(compute)
            ).reshape(count * degree, B).to(store)
            for count, degree, edges, _ in t.chk_buckets
        ])
        v2c_parts, llr_parts = [], []
        for qp, (count, degree, edges) in zip(q_parts, t.var_buckets):
            if degree == 0:
                llr_parts.append(qp)
                continue
            y = c2v[edges].view(count, degree, B).to(compute)
            v2c_b, llr_b = arithmetic.var_update(qp, y)
            v2c_parts.append(v2c_b.reshape(count * degree, B).to(store))
            llr_parts.append(llr_b)
        v2c = torch.cat(v2c_parts)
        hard = arithmetic.hard_decision(torch.cat(llr_parts))
        return hard.view(1, n, 1, B)

    def freeze(bits, frozen, conv, iters, it, counter):
        flags = syndrome_flags(t.chk_buckets, bits.view(n, B))
        freeze_on_flags(flags, bits, frozen, conv, iters, it, counter)

    bits0 = hard0.view(1, n, 1, B)
    bits, iters, conv = decode_loop(bits0, bits0, step, freeze, max_iterations)
    codeword = bits.view(n, B)[t.inv_var_order].T.to(torch.uint8)
    return {
        "codeword": codeword,
        "iterations": iters.view(B),
        "success": conv.view(B).to(torch.bool),
    }
