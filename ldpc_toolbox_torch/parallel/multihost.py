"""Starting the ranks of a sharded BER run.

Counterpart of ``ldpc_toolbox_tpu.parallel.multihost``. The BER harness
shards the codeword batch over ranks, one process a device; the code is
replicated and the per-step counter reduction, a few scalars, is the only
traffic between ranks. Every rank runs the same program, and each step
draws its message and noise from a generator seeded by (seed, point,
step), so the Monte-Carlo stream does not depend on the number of ranks.

Usage, one process a card (``torchrun --nproc-per-node N script.py``)::

    from ldpc_toolbox_torch.parallel.multihost import global_mesh, initialize
    initialize()                     # torchrun's environment, gloo
    mesh = global_mesh()             # every rank; cuda:LOCAL_RANK
    BerTestBuilder(..., mesh=mesh, device=mesh.device,
                   batch_size=global_batch).build().run()
    shutdown()                       # every rank, once the run is done

``shutdown`` ends the process group while the interpreter still runs, so
its threads are joined there: a group left to the interpreter's exit
aborted one rank in 20 of a two-rank run (``std::terminate`` from its
teardown), after the run's output was complete.
"""

from __future__ import annotations

import os

import torch.distributed as dist

from .mesh import default_mesh

__all__ = ["global_mesh", "initialize", "shutdown"]


def initialize(**kwargs) -> None:
    """Initialise ``torch.distributed`` over gloo (a no-op in a single
    process, or when it is initialised already).

    Under torchrun the settings come from its environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); explicit kwargs
    (``init_method="tcp://localhost:PORT"``, ``world_size``, ``rank``)
    pass through to ``init_process_group``. Without either there is
    nothing to join. A setup that was asked for and fails raises."""
    if dist.is_initialized():
        return
    if not kwargs and "WORLD_SIZE" not in os.environ:
        return  # a single process
    dist.init_process_group(backend="gloo", **kwargs)


def global_mesh(device=None):
    """The mesh over every rank of every host, this rank decoding on
    ``device`` (``parallel.mesh.default_mesh``: None means
    ``cuda:LOCAL_RANK``, and raises on a machine without a card)."""
    return default_mesh(device)


def shutdown() -> None:
    """End the process group ``initialize`` started, if any: its threads
    (gloo's and the TCP store's) are joined before this returns. Meshes
    hold the group weakly (``parallel.mesh``), so none keeps it alive;
    a mesh's collectives raise afterwards."""
    if dist.is_initialized():
        dist.destroy_process_group()
