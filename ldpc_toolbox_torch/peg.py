"""Progressive Edge Growth (PEG) LDPC construction.

Rebuild of the reference's ``src/peg.rs`` (Hu/Eleftheriou/Arnold 2005):
for each symbol node, add ``wc`` edges one by one; each edge goes to a
check node chosen by BFS from the symbol node — prefer unreachable checks,
else checks at maximum distance, tie-breaking by minimum degree and then
uniformly at random (peg.rs:93-112).

A copy of ``ldpc_toolbox_tpu.peg`` on this package's ``sparse`` and
``utils``; ``tests/test_torch_constructions.py`` holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .sparse import Node, SparseMatrix
from .utils.rng import Rng

__all__ = ["Config", "PegError"]


class PegError(RuntimeError):
    pass


@dataclass
class Config:
    nrows: int
    ncols: int
    wc: int  # column weight

    def run(self, seed: int) -> SparseMatrix:
        h = SparseMatrix(self.nrows, self.ncols)
        rng = Rng(seed)
        for col in range(self.ncols):
            for _ in range(self.wc):
                _insert_edge(h, col, rng)
        return h


def _insert_edge(h: SparseMatrix, col: int, rng) -> None:
    # Candidate order: unreachable (None distance) first, then decreasing
    # distance, then increasing degree — matching compare_some(...).reverse()
    # then weight (peg.rs:102-105) — with a uniformly random pick among the
    # minimal candidates (util.rs:57-73).  Vectorized over the BFS distance
    # array; the single random_range call consumes the identical ChaCha8
    # stream as the tuple-based sort_by_random_min it replaces.
    if h.num_rows == 0:
        raise PegError("not enough rows available")
    dist_r, _ = h.bfs_arrays(Node.col(col))
    w = h.row_weights_array()
    unreach = dist_r < 0
    pool = unreach if unreach.any() else dist_r == dist_r.max()
    wmin = w[pool].min()
    cands = np.flatnonzero(pool & (w == wmin))
    sel = int(cands[rng.random_range(int(cands.size))])
    h.insert(sel, col)
