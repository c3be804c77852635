"""Carry a code's decode tables onto a device.

This system has no trained weights: its parameters are the index tables
of the code's flat layout. ``layout_to_device`` takes a ``FusedLayout``,
either the JAX package's or this package's (both hold numpy arrays), and
returns the tensors the layered decode reads, so both packages can decode
on identical tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DeviceLayout", "layout_to_device"]


@dataclass(frozen=True)
class DeviceLayout:
    """The layered decode's tables on one device (int32, check-major edge
    order). ``chk_meta`` is static: per degree bucket, check groups
    [g0, g1) of degree d whose first edge is ebase."""

    Z: int
    E: int
    CG: int
    VG: int
    chk_meta: tuple
    chk_cs: torch.Tensor  # (CG,) first edge of each check group
    syn_vg: torch.Tensor  # (E,) var-group plane of each edge
    syn_rot: torch.Tensor  # (E,) roll var->check = s
    rot_cv: torch.Tensor  # (E,) roll check->var = (Z - s) % Z
    syn_mask: torch.Tensor  # (E,) missing lane in check coords, -1 none

    @property
    def max_chk_degree(self) -> int:
        return max((m.d for m in self.chk_meta), default=0)


def layout_to_device(layout, device) -> DeviceLayout:
    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    rot_cv = (layout.Z - np.asarray(layout.syn_rot)) % layout.Z
    return DeviceLayout(
        Z=int(layout.Z),
        E=int(layout.E),
        CG=int(layout.CG),
        VG=int(layout.VG),
        chk_meta=tuple(layout.chk_meta),
        chk_cs=put(layout.chk_cs),
        syn_vg=put(layout.syn_vg),
        syn_rot=put(layout.syn_rot),
        rot_cv=put(rot_cv),
        syn_mask=put(layout.syn_mask),
    )
