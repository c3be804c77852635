"""P4: contiguous against scattered writes of min-sum outputs.

Ports ``tools/prof_v2.py`` of the JAX package (``make``: its TPU kernels
read (d, Z, Bt) blocks of a group's d planes and write the min-sum outputs
back as a block, or plane by plane to scattered positions by DMA, rolled
first or not). On src (nbt, G, d, Z, Bt) bf16:

- ``copy``: ``plane_copy``, out = src (``stream_kernel<T, Identity>`` of
  ``csrc/probes.cu``, P1's stream with nothing done between load and
  store);
- ``contig``: ``minsum_planes``, the min-sum outputs of each group's d
  planes in place of its inputs (``minsum_planes_kernel``);
- ``scatw``: output t of group g to plane dest[g d + t] of (nbt, G d, Z,
  Bt), dest a permutation of range(G d);
- ``scatw_roll``: rolled along Z by shifts[g d + t] first (output lane z
  to lane z + shift mod Z).

The min-sum is the tool's, in f32: m1 the least |x| (the first of equal
ones), m2 min(m2, max(m1, |x|)) folded from 3.4e38, the parity of the
signs x < 0; output t is m2 at the argmin, else m1, negated where the
parity without x_t is odd; stored as bf16.

    python -m ldpc_toolbox_torch.probes.v2

prints each mode's time and GB/s (the tool's count: the input read and
the output written) for Bt = 128 and 256 (and 512 for copy) at B = 512, a
chain of launches timed by ``_kernels.chain_ms``; the copy in turns with
``Tensor.copy_``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

__all__ = ["MODES", "main", "minsum_planes", "minsum_planes_reference", "plane_copy",
           "plane_copy_reference"]

#: the tool's shapes: Z, groups, planes a group, frames
Z, G, D, B = 360, 90, 7, 512
P = G * D
MODES = ("copy", "contig", "scatw", "scatw_roll")
#: tile widths ``main`` runs a mode at (the tool's)
TILES = {"copy": (128, 256, 512), "contig": (128, 256), "scatw": (128, 256),
         "scatw_roll": (128, 256)}
_KIND = {"contig": 0, "scatw": 1, "scatw_roll": 2}
#: m2's start
_BIG = 3.4e38


def _check(src, name):
    if src.dim() != 5 or src.dtype != torch.bfloat16:
        raise TypeError(f"{name}: src must be (nbt, G, d, Z, Bt) bf16")
    if src.shape[4] % 8:
        raise ValueError(f"{name}: Bt must be a multiple of 8")


def plane_copy(src: torch.Tensor) -> torch.Tensor:
    """A copy of src (nbt, G, d, Z, Bt) bf16. On a CUDA tensor it launches
    the kernel, on a CPU tensor it runs the plain version."""
    if src.device.type == "cpu":
        return plane_copy_reference(src)
    _check(src, "plane_copy")
    stream = _kernels.on_card("plane_copy", src)
    out = torch.empty_like(src)
    lib = _kernels.lib()
    err = lib.ldpc_probe_copy(src.data_ptr(), out.data_ptr(), src.nbytes, stream)
    _kernels.raise_on(lib, err, "plane_copy")
    plane_copy.launches += 1
    return out


def plane_copy_reference(src: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``plane_copy`` (any device)."""
    return src.clone()


def minsum_planes(src, mode: str, dest=None, shifts=None) -> torch.Tensor:
    """The min-sum outputs of ``mode`` (contig, scatw, scatw_roll; see the
    module) of src (nbt, G, d, Z, Bt) bf16, d at most 8; dest and shifts
    (G d,) int32 for the scattered modes (shifts in [0, Z)). A new tensor.
    On a CUDA tensor it launches the kernel, on a CPU tensor it runs the
    plain version."""
    if src.device.type == "cpu":
        return minsum_planes_reference(src, mode, dest, shifts)
    _check(src, "minsum_planes")
    nbt, g, d, z, bt = src.shape
    if mode not in _KIND or not 1 <= d <= 8:
        raise ValueError(f"mode must be one of {tuple(_KIND)} and d in [1, 8]")
    if mode == "contig":  # the kernel reads no table
        out = torch.empty_like(src)
        stream = _kernels.on_card("minsum_planes", src, out)
        tables = (None, None)
    else:
        if (dest is None or shifts is None or dest.dtype != torch.int32
                or shifts.dtype != torch.int32 or dest.shape != (g * d,)
                or shifts.shape != (g * d,)):
            raise TypeError("dest and shifts must be (G d,) int32")
        out = torch.empty((nbt, g * d, z, bt), dtype=src.dtype, device=src.device)
        stream = _kernels.on_card("minsum_planes", src, dest, shifts, out)
        tables = (dest.data_ptr(), shifts.data_ptr())
    lib = _kernels.lib()
    err = lib.ldpc_probe_minsum(src.data_ptr(), *tables, out.data_ptr(), nbt, g, d, z, bt,
                                _KIND[mode], stream)
    _kernels.raise_on(lib, err, "minsum_planes")
    minsum_planes.launches += 1
    return out


#: kernel launches since the count was last set to 0
plane_copy.launches = 0
minsum_planes.launches = 0


def minsum_planes_reference(src, mode: str, dest=None, shifts=None) -> torch.Tensor:
    """The plain PyTorch version of ``minsum_planes`` (any device)."""
    if mode not in _KIND:
        raise ValueError(f"mode must be one of {tuple(_KIND)}")
    nbt, g, d, z, bt = src.shape
    x = src.float()
    mags, negs = x.abs(), x < 0
    m1 = mags[:, :, 0]
    m2 = torch.full_like(m1, _BIG)
    arg = torch.zeros(m1.shape, dtype=torch.int32, device=src.device)
    par = negs[:, :, 0]
    for k in range(1, d):
        mk = mags[:, :, k]
        m2 = torch.minimum(m2, torch.maximum(m1, mk))
        take = mk < m1
        m1 = torch.where(take, mk, m1)
        arg = torch.where(take, k, arg)
        par = par ^ negs[:, :, k]
    outs = []
    for t in range(d):
        loo = torch.where(arg == t, m2, m1)
        outs.append(torch.where(par ^ negs[:, :, t], -loo, loo))
    o = torch.stack(outs, dim=2).to(torch.bfloat16)
    if mode == "contig":
        return o
    o = o.reshape(nbt, g * d, z, bt)
    if mode == "scatw_roll":
        lane = torch.arange(z, device=src.device)
        rows = (lane[None, :] - shifts.long()[:, None]) % z  # (G d, Z)
        o = torch.gather(o, 2, rows[None, :, :, None].expand(nbt, -1, -1, bt))
    out = torch.empty_like(o)
    out[:, dest.long()] = o
    return out


def inputs(bt: int, seed: int = 0, device="cuda", b=B, g=G, d=D, z=Z):
    """Seeded inputs of a tile width: src (B / bt, G, d, Z, bt) normal
    bf16, dest a permutation of range(G d), shifts in [0, Z)."""
    rng = np.random.default_rng(seed)
    dest = rng.permutation(g * d).astype(np.int32)
    shifts = rng.integers(0, z, g * d).astype(np.int32)
    src = rng.standard_normal((b // bt, g, d, z, bt)).astype(np.float32)
    return (torch.from_numpy(src).to(device, torch.bfloat16), torch.from_numpy(dest).to(device),
            torch.from_numpy(shifts).to(device))


def run(mode, src, dest, shifts):
    """One call of ``mode``'s kernel."""
    return plane_copy(src) if mode == "copy" else minsum_planes(src, mode, dest, shifts)


def main():
    print(_kernels.card_line())
    for mode in MODES:
        for bt in TILES[mode]:
            src, dest, shifts = inputs(bt)
            fns = {mode: lambda: run(mode, src, dest, shifts)}
            if mode == "copy":
                out = torch.empty_like(src)
                fns["Tensor.copy_"] = lambda: out.copy_(src)
            found = _kernels.turns(fns, launches=30)
            print(f"{mode:11s} Bt={bt:3d}: " + "; ".join(
                f"{name} {t.ms:7.4f} ms {2 * src.nbytes / t.ms / 1e6:4.0f} GB/s"
                for name, t in found.items()), flush=True)


if __name__ == "__main__":
    main()
