"""Rolled plane gather: the data movement of the plane-gather flooding path.

Counterpart of ``ldpc_toolbox_tpu.ops.plane_gather``. With ``src (P, Z,
B)`` and ``planes``, ``shifts`` (G, d) integer arrays,

    out[g, t, l, :] = src[planes[g, t], (l - shifts[g, t]) % Z, :]

each output plane is one whole ``(Z, B)`` plane of ``src`` rolled along
the lane axis: for a lifted code, the message permutation between
variable and check coordinates. The JAX package lowers it as one flat XLA
gather, not a Pallas kernel; here it is one flat ``index_select`` of the
``(P * Z, B)`` rows, on either device. ``plane_index`` builds the flat row
index once, so a decode that gathers the same planes every iteration keeps
it on its device (``decoder/lifted_flooding.plane_tables``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gather_planes", "plane_gather", "plane_index"]


def plane_index(planes, shifts, Z: int, device) -> torch.Tensor:
    """The flat row index of ``plane_gather`` for (G, d) ``planes`` and
    ``shifts``: ``planes[g, t] * Z + (l - shifts[g, t]) % Z`` for each lane
    l, as a (G * d * Z,) int64 tensor on ``device``."""
    planes = np.asarray(planes, np.int64)
    shifts = np.asarray(shifts, np.int64)
    lanes = (np.arange(Z)[None, None, :] - shifts[:, :, None]) % Z
    flat = planes[:, :, None] * Z + lanes
    return torch.as_tensor(flat.reshape(-1), device=device)


def gather_planes(src: torch.Tensor, index: torch.Tensor, G: int, d: int) -> torch.Tensor:
    """(P, Z, B) ``src`` gathered by a ``plane_index`` of (G, d) planes:
    (G, d, Z, B)."""
    P, Z, B = src.shape
    return src.reshape(P * Z, B).index_select(0, index).reshape(G, d, Z, B)


def plane_gather(src: torch.Tensor, planes, shifts) -> torch.Tensor:
    """Gather rolled planes: (P, Z, B) ``src``, (G, d) ``planes`` and
    ``shifts`` -> (G, d, Z, B)."""
    G, d = np.shape(planes)
    return gather_planes(src, plane_index(planes, shifts, src.shape[1], src.device), G, d)
