"""Carry a code's decode tables onto a device.

This system has no trained weights: its parameters are the index tables
of the code's flat layout. ``layout_to_device`` takes a ``FusedLayout``,
either the JAX package's or this package's (both hold numpy arrays), and
returns the tensors the layered and flooding decodes read, so both
packages can decode on identical tables. The ``rec_*`` reconstruction
tables, which only the port's compressed flooding kernel reads, are
derived here from the layout's own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ops.fused_bp2 import var_recon_tables

__all__ = ["DeviceLayout", "layout_to_device"]


@dataclass(frozen=True)
class DeviceLayout:
    """The decode tables on one device (int32). ``chk_*`` and ``syn_*``
    edge tables are in check-major edge order, ``var_*`` and ``rec_*`` in
    var-major order. ``chk_meta`` and ``var_meta`` are static: per degree
    bucket, groups [g0, g1) of degree d whose first edge is ebase."""

    Z: int
    E: int
    CG: int
    VG: int
    chk_meta: tuple
    var_meta: tuple
    chk_cs: torch.Tensor  # (CG,) first edge of each check group
    chk_dest: torch.Tensor  # (E,) var-major c2v plane of each edge
    chk_rot: torch.Tensor  # (E,) roll check->var = (Z - s) % Z
    chk_omask: torch.Tensor  # (E,) missing lane in var coords, -1 none
    var_cs: torch.Tensor  # (VG,) first edge of each var group
    var_dest: torch.Tensor  # (E,) check-major v2c plane of each edge
    var_rot: torch.Tensor  # (E,) roll var->check = s
    var_omask: torch.Tensor  # (E,) missing lane in check coords, -1 none
    syn_vg: torch.Tensor  # (E,) var-group plane of each edge
    syn_rot: torch.Tensor  # (E,) roll var->check = s
    syn_mask: torch.Tensor  # (E,) missing lane in check coords, -1 none
    rec_plane: torch.Tensor  # (E,) check-major edge feeding var-major edge p
    rec_group: torch.Tensor  # (E,) its check group
    rec_slot: torch.Tensor  # (E,) its slot in the group
    rec_rot: torch.Tensor  # (E,) its roll check->var

    @property
    def max_chk_degree(self) -> int:
        return max((m.d for m in self.chk_meta), default=0)


def layout_to_device(layout, device) -> DeviceLayout:
    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    plane, group, slot, rot = var_recon_tables(layout)
    return DeviceLayout(
        Z=int(layout.Z),
        E=int(layout.E),
        CG=int(layout.CG),
        VG=int(layout.VG),
        chk_meta=tuple(layout.chk_meta),
        var_meta=tuple(layout.var_meta),
        chk_cs=put(layout.chk_cs),
        chk_dest=put(layout.chk_dest),
        chk_rot=put(layout.chk_rot),
        chk_omask=put(layout.chk_omask),
        var_cs=put(layout.var_cs),
        var_dest=put(layout.var_dest),
        var_rot=put(layout.var_rot),
        var_omask=put(layout.var_omask),
        syn_vg=put(layout.syn_vg),
        syn_rot=put(layout.syn_rot),
        syn_mask=put(layout.syn_mask),
        rec_plane=put(plane),
        rec_group=put(group),
        rec_slot=put(slot),
        rec_rot=put(rot),
    )
