"""Converged-frame compaction for the streaming (one launch an iteration)
decodes.

Counterpart of the JAX package's ``decoder/compaction.py
staged_while_decode``. A streaming loop runs every tile until the batch's
slowest frame converges, so at working Eb/N0 most of its work goes to
frames that have already converged. Staged halving gives the early exit
back at tile granularity:

* stage 0: all ``nbt`` tiles iterate while more than ``ceil(nbt/2) * bt``
  frames are unconverged;
* compaction: a stable argsort puts the unconverged frames first; the
  first ``ceil(nbt/2) * bt`` frames of the state and of the constant
  tiles are gathered into new tiles, and the permutation is kept;
* stage 1 runs on those tiles while more than ``ceil(nbt/4) * bt``
  remain, and so on down to one tile, which runs until its frames have
  all converged or the iteration budget is spent. A stage whose frames
  already fit the next stage's tiles would run no iteration: it is skipped,
  gather and scatter included.

One iteration counter spans the stages, and each stage scatters its
frames' results back to the original frame order, so the output is
bit-identical to the unstaged loop: a frame's trajectory does not depend
on its batchmates, and a frame leaves the active tiles only once it has
converged (or the budget is spent). Each iteration's convergence test and
freeze is one step (``freeze``: on the card ``ops.fused_bp2
.fused_syndrome_freeze``, one launch of the syndrome kernel), and the loop
reads the device once an iteration: the count of unconverged frames that
step leaves.
"""

from __future__ import annotations

import torch

from ..ops.fused_bp2 import freeze_on_flags

__all__ = ["stage_sizes", "staged_while_decode"]


def stage_sizes(nbt: int) -> list:
    """Tiles of each stage: nbt, ceil(nbt/2), ..., 1."""
    sizes = [nbt]
    while sizes[-1] > 1:
        sizes.append((sizes[-1] + 1) // 2)
    return sizes


def _frames(x):
    """(t, ..., bt) tiles -> (t * bt, ...) frames, frame = tile * bt +
    lane."""
    return x.movedim(-1, 1).reshape(x.shape[0] * x.shape[-1], *x.shape[1:-1])


def _tiles(x, bt):
    """(t * bt, ...) frames -> (t, ..., bt) contiguous tiles."""
    return x.reshape(x.shape[0] // bt, bt, *x.shape[1:]).movedim(1, -1).contiguous()


def staged_while_decode(*, max_iterations, state, const, bits0, iteration,
                        syndrome=None, freeze=None):
    """Run the staged-compaction decode loop.

    state: tiled iteration-state tensors, each (nbt, ..., bt); const:
    tiled read-only per-frame tensors the iteration needs (gathered at each
    compaction too); bits0: (nbt, VG, Z, bt) int8 raw-channel hard
    decisions (iteration 0 tests them); iteration(state, const) -> (state',
    bits) runs one iteration on any tile count; freeze(bits, frozen, conv,
    iters, it, counter) tests iteration it's bits and freezes in place (the
    contract of ``fused_syndrome_freeze`` without its layout); or, instead,
    syndrome(bits) -> (tiles, bt) int32 flags, nonzero where a frame has an
    unsatisfied check, under the plain freeze (``freeze_on_flags``, that
    of ``fused_syndrome_freeze_reference``).

    Returns (bits (nbt, VG, Z, bt) int8, iters (nbt, bt) int32, conv (nbt,
    bt) int32) in the original frame order: the contract of the resident
    decodes.
    """
    if freeze is None:
        def freeze(bits, *loop_state):
            freeze_on_flags(syndrome(bits), bits, *loop_state)
    nbt, _, _, bt = bits0.shape
    dev = bits0.device
    out = _frames(bits0).clone()
    iters_out = torch.zeros(nbt * bt, dtype=torch.int32, device=dev)
    conv_out = torch.zeros(nbt * bt, dtype=torch.bool, device=dev)
    perm = torch.arange(nbt * bt, device=dev)
    state, const = tuple(state), tuple(const)
    # a frame's frozen bits are written when it first passes and read only
    # if it did
    bits, frozen = bits0, torch.empty_like(bits0)
    conv = torch.zeros(nbt * bt, dtype=torch.bool, device=dev)
    iters = torch.zeros(nbt * bt, dtype=torch.int32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    freeze(bits0, frozen, conv, iters, 0, counter)
    active = int(counter)
    it = 0
    sizes = stage_sizes(nbt)
    for si, tiles in enumerate(sizes):
        cap = sizes[si + 1] * bt if si + 1 < len(sizes) else 0
        if si:
            if it >= max_iterations or not active:
                break
            if active <= cap:
                continue
            sel = torch.argsort(conv.to(torch.uint8), stable=True)[: tiles * bt]

            def gather(x):  # frames sel of x, as tiles
                return _tiles(_frames(x)[sel], bt)

            state = tuple(gather(x) for x in state)
            const = tuple(gather(x) for x in const)
            bits, frozen = gather(bits), gather(frozen)
            perm, conv, iters = perm[sel], conv[sel], iters[sel]
        while it < max_iterations and active > cap:
            state, bits = iteration(state, const)
            it += 1
            freeze(bits, frozen, conv, iters, it, counter)
            active = int(counter)
        out[perm] = _frames(torch.where(conv.reshape(tiles, 1, 1, bt), frozen, bits))
        iters_out[perm] = torch.where(conv, iters, max_iterations).to(torch.int32)
        conv_out[perm] = conv
    return (
        _tiles(out, bt),
        iters_out.reshape(nbt, bt),
        conv_out.to(torch.int32).reshape(nbt, bt),
    )
