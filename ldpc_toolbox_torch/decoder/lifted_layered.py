"""Horizontal-layered BP on the block-circulant (lifted) layout.

Counterpart of ``ldpc_toolbox_tpu.decoder.lifted_layered``. A layer is one
check group: Z structurally parallel checks, each touching a distinct lane
of each incident variable group, except where a group holds two base edges
into the same variable group (DVB-S2); those deltas add against the
layer-entry Qv in edge order. Layer order is check-bucket-major (the flat
layout's group order), not the reference's 0..m row sweep.

``lifted_layered_decode`` dispatches by the LLRs' device:

* CUDA: the tile glue of ``_fused_layered_decode`` around the hand-written
  kernel (``ops/resident_layered.py``);
* CPU: ``plain_layered_decode``, the twin of the JAX package's jnp path.

Both give the same success, iterations and codewords.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import layout_to_device
from ..ops.fused_bp2 import build_fused_layout, rule_for
from ..ops.resident_layered import (
    BT,
    layered_decode_planes,
    resident_layered_decode,
)
from .lifted import LiftedGraph

__all__ = ["lifted_layered_decode", "plain_layered_decode", "tile_inputs"]


def lifted_layered_decode(
    lg: LiftedGraph, arithmetic, llrs: torch.Tensor, max_iterations: int
):
    """Decode a (B, n) batch of channel LLRs, layered schedule, lifted
    layout. Returns a dict of tensors on the LLRs' device: ``codeword``
    (B, n) uint8, ``iterations`` (B,) int32, ``success`` (B,) bool."""
    if llrs.device.type == "cuda":
        return _fused_layered_decode(lg, arithmetic, llrs, max_iterations)
    return plain_layered_decode(lg, arithmetic, llrs, max_iterations)


def _planes_of(lg, llrs):
    """Channel LLRs as f32 (VG, Z, B) planes in var-bucket group order."""
    col_of = lg.var_cols[lg.var_group_order]
    idx = torch.as_tensor(col_of.reshape(-1), device=llrs.device)
    planes = llrs.to(torch.float32).T[idx].reshape(
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
    its own check rule on one layer, and +inf in the missing lanes."""

    big = float("inf")

    def __init__(self, arithmetic):
        self.arithmetic = arithmetic
        self.storage_dtype = arithmetic.storage_dtype

    def layered_x(self, qv, rold):
        return self.arithmetic.layered_x(qv, rold)

    def check(self, x):
        d = x.shape[0]
        out = self.arithmetic.check_messages(x.reshape(1, d, -1))
        return out.reshape(x.shape)


def plain_layered_decode(lg, arithmetic, llrs, max_iterations):
    layout = layout_to_device(build_fused_layout(lg), llrs.device)
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


def tile_inputs(lg, arithmetic, llrs):
    """The kernel's inputs for a (B, n) batch of LLRs: qv0 and raw-channel
    bits as (nbt, VG, Z, BT) tiles (frames innermost; a partial last tile
    padded with +100-LLR frames, which converge at iteration 0), the
    device layout and the rule."""
    rule = rule_for(arithmetic)
    if rule is None:
        raise NotImplementedError(
            f"{type(arithmetic).__name__} has no kernel yet (ROADMAP A6)"
        )
    if llrs.shape[0] % BT:
        pad = llrs.new_full((BT - llrs.shape[0] % BT, llrs.shape[1]), 100.0)
        llrs = torch.cat([llrs, pad])
    nbt = llrs.shape[0] // BT
    llr_planes, _ = _planes_of(lg, llrs)
    q = arithmetic.quantize(llr_planes)
    qv0 = arithmetic.llr_to_var_llr(q).to(arithmetic.var_llr_storage_dtype)

    def tile(x):  # (P, Z, B) -> (nbt, P, Z, Bt)
        return x.reshape(x.shape[0], lg.Z, nbt, BT).permute(2, 0, 1, 3).contiguous()

    layout = layout_to_device(build_fused_layout(lg), llrs.device)
    return tile(qv0), tile((llr_planes <= 0).to(torch.int8)), layout, rule


def _fused_layered_decode(lg, arithmetic, llrs, max_iterations):
    """Tile glue around ``resident_layered_decode``."""
    qv0_t, bits0_t, layout, rule = tile_inputs(lg, arithmetic, llrs)
    bits, iters, conv = resident_layered_decode(
        qv0_t, bits0_t, layout, rule, max_iterations
    )
    nbt, VG, Z, Bt = bits.shape
    planes = bits.permute(1, 2, 0, 3).reshape(VG, Z, nbt * Bt)
    col_of = lg.var_cols[lg.var_group_order]
    B_user = llrs.shape[0]
    return {
        "codeword": _codeword_from_planes(lg, col_of, planes)[:B_user],
        "iterations": iters.reshape(-1)[:B_user],
        "success": (conv.reshape(-1) != 0)[:B_user],
    }
