"""Horizontal-layered belief propagation on a generic parity-check matrix.

Counterpart of ``ldpc_toolbox_tpu.decoder.layered`` (the reference's
serial per-check schedule, ``decoder/horizontal_layered.rs``): the state
is the variable posteriors Qv and the per-edge check messages Rcv; each
check subtracts its old message, recomputes and updates Qv in place
(horizontal_layered.rs:105-110).

The sweep walks the layers of ``decoder/layout.extract_layers``, groups of
variable-disjoint checks in an order serial-equivalent to the reference's
0..m sweep. Rcv is stored layer-major ``(L, R, dc_max, B)`` on the padded
check tables, and a layer is one gather of Qv, the arithmetic's masked
rule and one indexed assignment of Qv: a variable is touched at most once
a layer, so ``Qv[v] = Qv[v] + delta`` adds exactly what the JAX package's
gather through its source table adds (the padded slots point at a
sentinel row that stays 0). Iteration 0 tests the raw channel bits; the
test and freeze of each sweep's hard bits, and the loop, are those of
``decoder/flooding.py`` on the padded check table.

Torch ops, not hand-written kernels, as in ``decoder/flooding.py``; a
layer costs a few dozen launches, so a code whose layers hold one check
each (the DVB-S2 staircase: 32400 layers for R1_2) sweeps slowly.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fused_bp2 import freeze_on_flags
from ..ops.resident_flooding import decode_loop
from .layout import DecodeGraph

__all__ = ["LayeredTables", "device_layers", "layered_decode", "layered_sweep"]


@dataclass
class LayeredTables:
    """A DecodeGraph's padded layer tables on one device: per layer, the
    Qv rows of its (R * dc) check slots (the sentinel row n where padded)
    and the (R, dc) slot mask; and the (m * dc) Qv rows of every check's
    slots, for the syndrome."""

    n: int
    m: int
    dc: int
    rows: int  # R, checks a layer (padded)
    layer_vars: list  # L tensors (R * dc,) int64
    layer_masks: list  # L tensors (R, dc, 1) bool
    chk_vars: torch.Tensor  # (m * dc,) int64


#: (id(graph), device) -> LayeredTables, each dropped when its graph dies
_TABLES: dict = {}


def device_layers(graph: DecodeGraph, device) -> LayeredTables:
    """The graph's layer tables on a device, built and copied once per
    (graph, device)."""
    assert graph.layers is not None, "DecodeGraph built without layers"
    key = (id(graph), torch.device(device))
    tables = _TABLES.get(key)
    if tables is None:
        m, n, dc = graph.m, graph.n, graph.dc_max
        layers = np.asarray(graph.layers)  # (L, R) padded with m
        R = layers.shape[1]
        chk_vars = np.concatenate([graph.chk_vars, np.full((1, dc), n, np.int32)])
        chk_mask = np.concatenate([graph.chk_mask, np.zeros((1, dc), bool)])
        vars_lm = torch.as_tensor(chk_vars[layers].astype(np.int64), device=device)
        mask_lm = torch.as_tensor(chk_mask[layers], device=device)
        tables = _TABLES[key] = LayeredTables(
            n=n, m=m, dc=dc, rows=R,
            layer_vars=list(vars_lm.reshape(len(layers), R * dc).unbind(0)),
            layer_masks=list(mask_lm[..., None].unbind(0)),
            chk_vars=torch.as_tensor(
                np.asarray(graph.chk_vars, np.int64).reshape(-1), device=device),
        )
        weakref.finalize(graph, _TABLES.pop, key, None)
    return tables


def syndrome_flags(t: LayeredTables, hard):
    """(1, B) int32, nonzero where a frame of ``hard`` ((n, B) bits) leaves
    a check unsatisfied (the padded slots read a zero bit)."""
    bits = hard.to(torch.int32)
    bits = torch.cat([bits, bits.new_zeros((1, bits.shape[1]))])
    g = bits[t.chk_vars].view(t.m, t.dc, -1)
    return ((g.sum(dim=1, dtype=torch.int32) & 1) != 0).any(dim=0).to(torch.int32)[None]


def layered_sweep(qv, rcv, t: LayeredTables, arithmetic):
    """One sweep over every layer, in place: Qv (n + 1, B) in the
    arithmetic's posterior storage type (row n the sentinel, 0), Rcv
    (L, R, dc, B) in its message storage type."""
    R, dc, B = t.rows, t.dc, qv.shape[1]
    compute = arithmetic.compute_dtype
    store = arithmetic.storage_dtype
    for layer, (idx, mask_e) in enumerate(zip(t.layer_vars, t.layer_masks)):
        qv_s = qv[idx]
        rold = rcv[layer].to(compute)
        x = arithmetic.layered_x(qv_s.view(R, dc, B).to(compute), rold)
        rnew = torch.where(mask_e, arithmetic.check_messages(x, mask_e[..., 0]), rold)
        delta = torch.where(mask_e, arithmetic.layered_qv_delta(rnew, rold), 0)
        qv[idx] = qv_s + delta.view(R * dc, B).to(qv.dtype)
        rcv[layer] = rnew.to(store)


def layered_decode(graph: DecodeGraph, arithmetic, llrs, max_iterations: int):
    """Decode a batch of LLR frames with the horizontal-layered schedule,
    on their device. Same contract as ``flooding_decode``."""
    t = device_layers(graph, llrs.device)
    n = t.n
    llr_t = llrs.T.contiguous()  # (n, B)
    B = llr_t.shape[1]
    hard0 = llr_t <= 0
    q = arithmetic.quantize(llr_t)
    qv = torch.cat([
        arithmetic.llr_to_var_llr(q).to(arithmetic.var_llr_storage_dtype),
        torch.zeros((1, B), dtype=arithmetic.var_llr_storage_dtype, device=llrs.device),
    ])
    rcv = torch.zeros((len(t.layer_vars), t.rows, t.dc, B),
                      dtype=arithmetic.storage_dtype, device=llrs.device)

    def step():
        layered_sweep(qv, rcv, t, arithmetic)
        out_llr = arithmetic.var_llr_to_llr(qv[:n].to(arithmetic.compute_dtype))
        return arithmetic.hard_decision(out_llr).view(1, n, 1, B)

    def freeze(bits, frozen, conv, iters, it, counter):
        freeze_on_flags(syndrome_flags(t, bits.view(n, B)), bits, frozen, conv,
                        iters, it, counter)

    bits0 = hard0.view(1, n, 1, B)
    bits, iters, conv = decode_loop(bits0, bits0, step, freeze, max_iterations)
    return {
        "codeword": bits.view(n, B).T.to(torch.uint8),
        "iterations": iters.view(B),
        "success": conv.view(B).to(torch.bool),
    }
