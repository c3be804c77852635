"""MacKay-Neal pseudorandom LDPC construction.

Capability-parity rebuild of the reference's ``src/mackay_neal.rs``:
column-by-column fill with a maximum row weight, Random/Uniform fill
policies (mackay_neal.rs:148-154), optional minimum-girth enforcement with
retrial budgets (mackay_neal.rs:188-197), column backtracking
(mackay_neal.rs:227-239), and a parallel multi-seed search
(mackay_neal.rs:121-127; here a process/thread pool on the host — graph
search is not tensor math and stays off the device).

A copy of ``ldpc_toolbox_tpu.mackay_neal`` on this package's ``sparse``
and ``utils``; ``tests/test_torch_constructions.py`` holds the two equal.
"""

from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass
from enum import Enum
from typing import Optional

from .sparse import Node, SparseMatrix
from .utils.rng import Rng, choose_multiple, sort_by_random_sel

__all__ = ["FillPolicy", "Config", "MacKayNealError"]


class MacKayNealError(RuntimeError):
    pass


class FillPolicy(Enum):
    """Row selection policy when adding a column (mackay_neal.rs:148-154)."""

    RANDOM = "random"
    UNIFORM = "uniform"


@dataclass
class Config:
    nrows: int
    ncols: int
    wr: int  # maximum row weight
    wc: int  # column weight
    backtrack_cols: int = 0
    backtrack_trials: int = 0
    min_girth: Optional[int] = None
    girth_trials: int = 0
    fill_policy: FillPolicy = FillPolicy.UNIFORM

    def run(self, seed: int) -> SparseMatrix:
        """Run the construction with one seed; raises MacKayNealError on
        failure (mackay_neal.rs:110)."""
        return _MacKayNeal(self, seed).run()

    def search(
        self, start_seed: int, max_tries: int, max_workers: Optional[int] = None
    ) -> Optional[tuple[int, SparseMatrix]]:
        """Try seeds ``start_seed..start_seed+max_tries`` in parallel; return
        the first success found (mackay_neal.rs:121-127).

        The search fans out over *processes* (the graph search is
        pure-Python and CPU-bound, so threads would serialize on the GIL
        — rayon ``find_any`` semantics need real cores).  The ``spawn``
        start method keeps workers safe in processes that have imported
        torch; children import only this host-side module.  Queued seeds
        are cancelled as soon as a success lands; already-running seeds
        finish in the background, as with rayon.
        """
        max_workers = max_workers or min(32, os.cpu_count() or 1)
        seeds = range(start_seed, start_seed + max_tries)
        if max_workers <= 1 or max_tries <= 1:
            for s in seeds:
                h = _try_seed(self, s)
                if h is not None:
                    return (s, h)
            return None
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(
            min(max_workers, max_tries),
            mp_context=multiprocessing.get_context("spawn"),
        )
        try:
            futures = {pool.submit(_try_seed, self, s): s for s in seeds}
            for fut in concurrent.futures.as_completed(futures):
                h = fut.result()
                if h is not None:
                    return (futures[fut], h)
            return None
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def _try_seed(conf: Config, seed: int) -> Optional[SparseMatrix]:
    try:
        return conf.run(seed)
    except MacKayNealError:
        return None


class _NoAvailRows(MacKayNealError):
    pass


class _GirthTooSmall(MacKayNealError):
    pass


class _MacKayNeal:
    def __init__(self, conf: Config, seed: int):
        self.wr = conf.wr
        self.wc = conf.wc
        self.h = SparseMatrix(conf.nrows, conf.ncols)
        self.rng = Rng(seed)
        self.backtrack_cols = conf.backtrack_cols
        self.backtrack_trials = conf.backtrack_trials
        self.min_girth = conf.min_girth
        self.girth_trials = conf.girth_trials
        self.fill_policy = conf.fill_policy
        self.current_col = 0

    def _select_rows(self) -> list[int]:
        if self.fill_policy is FillPolicy.RANDOM:
            # lazily-filtered reservoir selection, bit-identical RNG
            # consumption to the reference (mackay_neal.rs:205-216)
            avail = (
                r for r in range(self.h.num_rows) if self.h.row_weight(r) < self.wr
            )
            pick = choose_multiple(self.rng, avail, self.wc)
            if len(pick) < self.wc:
                raise _NoAvailRows("no rows available")
            return pick
        # UNIFORM: lowest-weight rows first, random ties
        avail = [
            (r, self.h.row_weight(r))
            for r in range(self.h.num_rows)
            if self.h.row_weight(r) < self.wr
        ]
        sel = sort_by_random_sel(avail, self.wc, lambda rw: rw[1], self.rng)
        if sel is None:
            raise _NoAvailRows("no rows available")
        return [r for r, _ in sel]

    def _try_insert_column(self) -> None:
        rows = self._select_rows()
        self.h.insert_col(self.current_col, rows)
        if self.min_girth is not None:
            g = self.h.girth_at_node_with_max(
                Node.col(self.current_col), self.min_girth - 1
            )
            if g is not None:
                self.h.clear_col(self.current_col)
                raise _GirthTooSmall("girth is too small")

    def _backtrack(self) -> None:
        if self.backtrack_trials == 0:
            raise MacKayNealError("exceeded backtrack trials")
        self.backtrack_trials -= 1
        b = min(self.current_col, self.backtrack_cols)
        a = self.current_col - b
        for col in range(a, self.current_col):
            self.h.clear_col(col)
        self.current_col = a

    def _retry_girth(self) -> None:
        if self.girth_trials == 0:
            raise MacKayNealError("exceeded girth trials")
        self.girth_trials -= 1

    def run(self) -> SparseMatrix:
        while self.current_col < self.h.num_cols:
            try:
                self._try_insert_column()
                self.current_col += 1
            except _NoAvailRows:
                self._backtrack()
            except _GirthTooSmall:
                self._retry_girth()
        return self.h
