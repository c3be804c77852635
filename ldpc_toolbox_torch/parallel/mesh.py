"""Data-parallel Monte-Carlo decoding over ranks: one process a device.

Counterpart of ``ldpc_toolbox_tpu.parallel.mesh``. The JAX package shards
the codeword batch over a 1-D device mesh inside one program; here each
device has a process of its own (a rank of ``torch.distributed``, started
by ``torchrun`` or by hand), and a ``Mesh`` is this rank's view of the
world: the process group, its index, the world size and its device. Every
rank draws the whole batch and decodes its own rows (``shard_batch``); a
step's counters, a few scalars, are the only traffic between ranks. They
go over a gloo group on CPU tensors, so two ranks may share one card,
which NCCL refuses.

A mesh holds its process group weakly: ``torch.distributed`` owns the
group until ``multihost.shutdown`` ends it, and the group's threads
(gloo's and the TCP store's) end there, whatever meshes are left. A group
freed at interpreter exit instead can abort the process (a joinable
``std::thread`` destroyed: ``terminate called without an active
exception``).
"""

from __future__ import annotations

import os
import weakref

import torch
import torch.distributed as dist

__all__ = ["Mesh", "default_mesh", "max_over", "shard_batch", "sum_over"]


class Mesh:
    """One rank's view of the batch axis: ``group`` (the process group,
    None in a single process; held weakly, see the head of this module),
    ``rank`` and ``size`` in it, and the device this rank decodes on."""

    __slots__ = ("_ref", "rank", "size", "device")

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self._ref = None if group is None else weakref.ref(group)
        self.rank, self.size, self.device = rank, size, device

    @property
    def group(self):
        if self._ref is None:
            return None
        group = self._ref()
        if group is None:
            raise RuntimeError("the mesh's process group has been shut down")
        return group

    def __repr__(self):
        group = "None" if self._ref is None else repr(self._ref())
        return f"Mesh(group={group}, rank={self.rank}, size={self.size}, device={self.device!r})"


def default_mesh(devices=None) -> Mesh:
    """The mesh over every rank when ``torch.distributed`` is initialised
    (over gloo: ``multihost.initialize``), else a mesh of one. This rank's
    device is ``devices`` (a device or its name; None means ``cuda``);
    ``cuda`` without an index means ``cuda:LOCAL_RANK``. A CUDA device on a
    machine without a card raises; the mesh never falls back to the CPU."""
    if dist.is_available() and dist.is_initialized():
        rank, size, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    else:
        rank, size, group = 0, 1, None
    device = torch.device("cuda" if devices is None else devices)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name the device to decode on ('cpu')")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return Mesh(group=group, rank=rank, size=size, device=device)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of ``x``: the ``rank``-th of ``size`` equal slices
    of its leading axis. A batch the world size does not divide raises a
    ValueError."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {mesh.size} ranks")
    rows = x.shape[0] // mesh.size
    return x[mesh.rank * rows : (mesh.rank + 1) * rows]


def sum_over(mesh: Mesh, values: torch.Tensor) -> torch.Tensor:
    """``values`` summed over the ranks, on the CPU (one gloo all-reduce)."""
    values = values.cpu()
    if mesh.group is not None:
        dist.all_reduce(values, op=dist.ReduceOp.SUM, group=mesh.group)
    return values


def max_over(mesh: Mesh, value: float) -> float:
    """The largest of every rank's ``value`` (one gloo all-reduce)."""
    if mesh.group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t[0])
