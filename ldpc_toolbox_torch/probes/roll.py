"""P3: what a rotated gather costs: d rotated planes summed into one.

Ports ``tools/prof_roll.py`` of the JAX package (``make``: its TPU kernel
DMAs an aligned window of Z + 16 rows of each plane into vector memory and
rotates it there, by a static roll, a ``lax.switch`` of static rolls, or a
dynamic roll). ``rotated_gather`` launches ``rotated_gather_kernel`` of
``csrc/probes.cu``, where the rotation is an offset in the row index. For
src (nbt, P, 2 Z + 16, Bt) bf16, planes and shifts (G d,) int32 and e =
g d + t, output (nbt, G, Z, Bt) bf16 is the f32 sum in t order over t < d
of plane planes[e] at rows:

- ``switch``, ``dynroll``: Z - shifts[e] + z (one function, two TPU
  forms of it);
- ``dma``: hi + z, hi = Z - shifts[e] rounded down to a multiple of 16
  (the window as copied);
- ``roll0``: hi + (z - 5 mod Z + 16) (the window rolled by 5).

    python -m ldpc_toolbox_torch.probes.roll

prints each mode's time and GB/s (the bytes it reads and writes) at the
tool's shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

__all__ = ["MODES", "main", "rotated_gather", "rotated_gather_reference"]

#: the tool's shapes: Z, the window's alignment, Bt, groups, planes a
#: group, frame tiles, planes
Z, ALIGN, BT, G, D, NBT, P = 360, 16, 128, 90, 7, 4, 630
MODES = ("dma", "roll0", "switch", "dynroll")
_KIND = {"dma": 0, "roll0": 1, "switch": 2, "dynroll": 2}


def _shape(src, planes, shifts, d, align):
    """(Z, G) of a call, after checking its arguments' shapes."""
    if src.dim() != 4 or src.dtype != torch.bfloat16:
        raise TypeError("src must be (nbt, P, 2 Z + align, Bt) bf16")
    if (src.shape[2] - align) % 2 or src.shape[2] <= align:
        raise ValueError("src's rows must be 2 Z + align")
    if planes.dtype != torch.int32 or shifts.dtype != torch.int32:
        raise TypeError("planes and shifts must be int32")
    if planes.shape != shifts.shape or planes.dim() != 1 or planes.numel() % d:
        raise ValueError("planes and shifts must be (G d,)")
    return (src.shape[2] - align) // 2, planes.numel() // d


def rotated_gather(src, planes, shifts, mode: str, d: int = D, align: int = ALIGN):
    """The rotated gather of ``mode`` (see the module); a new (nbt, G, Z,
    Bt) bf16 tensor. Every shift in [0, Z), every plane in [0, P). On a
    CUDA tensor it launches the kernel (Bt a multiple of 8), on a CPU
    tensor it runs the plain version."""
    if src.device.type == "cpu":
        return rotated_gather_reference(src, planes, shifts, mode, d, align)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    z, g = _shape(src, planes, shifts, d, align)
    nbt, p, rows, bt = src.shape
    if bt % 8:
        raise ValueError("Bt must be a multiple of 8")
    out = torch.empty((nbt, g, z, bt), dtype=src.dtype, device=src.device)
    stream = _kernels.on_card("rotated_gather", src, planes, shifts, out)
    lib = _kernels.lib()
    err = lib.ldpc_probe_rotated_gather(src.data_ptr(), planes.data_ptr(), shifts.data_ptr(),
                                        out.data_ptr(), nbt, p, rows, z, bt, g, d, align,
                                        _KIND[mode], stream)
    _kernels.raise_on(lib, err, "rotated_gather")
    rotated_gather.launches += 1
    return out


#: kernel launches since the count was last set to 0
rotated_gather.launches = 0


def rotated_gather_reference(src, planes, shifts, mode: str, d: int = D, align: int = ALIGN):
    """The plain PyTorch version of ``rotated_gather`` (any device)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    z, g = _shape(src, planes, shifts, d, align)
    lane = torch.arange(z, device=src.device)
    start = z - shifts.long()
    hi = start // align * align
    if mode == "dma":
        rows = hi[:, None] + lane
    elif mode == "roll0":
        rows = hi[:, None] + (lane - 5) % (z + align)
    else:
        rows = start[:, None] + lane
    x = src[:, planes.long()[:, None], rows, :]  # (nbt, G d, Z, Bt)
    x = x.float().reshape(src.shape[0], g, d, z, src.shape[3])
    acc = x[:, :, 0]
    for t in range(1, d):
        acc = acc + x[:, :, t]
    return acc.to(torch.bfloat16)


def inputs(seed: int = 0, device="cuda", nbt=NBT, p=P, z=Z, bt=BT, g=G, d=D, align=ALIGN):
    """Seeded inputs at the tool's shapes (or others): src normal bf16,
    planes in [0, P) and shifts in [0, Z)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((nbt, p, 2 * z + align, bt), dtype=np.float32)
    planes = rng.integers(0, p, g * d).astype(np.int32)
    shifts = rng.integers(0, z, g * d).astype(np.int32)
    return (torch.from_numpy(src).to(device, torch.bfloat16), torch.from_numpy(planes).to(device),
            torch.from_numpy(shifts).to(device))


def moved_bytes(out: torch.Tensor, d: int = D) -> int:
    """The bytes a call reads and writes: d planes of Z rows read for each
    output plane, the output written."""
    return (d + 1) * out.nbytes


def main():
    print(_kernels.card_line())
    src, planes, shifts = inputs()
    for mode in MODES:
        out = rotated_gather(src, planes, shifts, mode)
        t = _kernels.chain_ms(lambda: rotated_gather(src, planes, shifts, mode), 30).ms
        print(f"{mode:8s} {t:.3f} ms  {moved_bytes(out) / t / 1e6:.0f} GB/s", flush=True)


if __name__ == "__main__":
    main()
