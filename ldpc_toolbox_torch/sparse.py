"""Sparse binary matrix (Tanner graph) with alist I/O, BFS and girth.

Host-side core data structure of the framework, mirroring the capability of
the reference's ``src/sparse.rs`` (SparseMatrix, alist read/write at
sparse.rs:250-389, girth APIs at sparse.rs:410-451) and ``src/sparse/bfs.rs``
(parent-excluding BFS with local-girth early exit, bfs.rs:53-109).

The alist text format emitted here is byte-identical to the reference so
that matrices interchange freely between the two implementations
(including MacKay's zero padding quirks for irregular codes).

A copy of ``ldpc_toolbox_tpu.sparse``, kept so that this package imports
nothing of the JAX package; ``tests/test_torch_layout.py`` holds the two
equal.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

__all__ = ["SparseMatrix", "Node", "BFSResults"]


@dataclass(frozen=True)
class Node:
    """A node of the bipartite Tanner graph: a row (check) or column (variable).

    Mirrors ``Node`` in the reference (sparse.rs:482-500).
    """

    kind: str  # "row" | "col"
    index: int

    @staticmethod
    def row(i: int) -> "Node":
        return Node("row", i)

    @staticmethod
    def col(i: int) -> "Node":
        return Node("col", i)


@dataclass
class BFSResults:
    """Distances from a BFS root; ``None`` marks unreachable nodes.

    Mirrors ``BFSResults`` (bfs.rs:37-42).
    """

    row_nodes_distance: list
    col_nodes_distance: list


def _adjacency(n, keys, values):
    """The adjacency lists of ``n`` nodes from their (key, value) edges in
    insertion order, and their padded (-1) mirror and degrees as
    ``_mirror_add`` grows it (width 4, doubled as needed)."""
    deg = np.bincount(keys, minlength=n).astype(np.int32)
    width = 4
    while width < (deg.max() if n else 0):
        width *= 2
    adj = np.full((n, width), -1, np.int32)
    order = np.argsort(keys, kind="stable")
    starts = np.cumsum(deg, dtype=np.int64) - deg
    slot = np.arange(len(keys)) - np.repeat(starts, deg)
    adj[keys[order], slot] = values[order]
    lists = [part.tolist() for part in np.split(values[order], np.cumsum(deg)[:-1])]
    return lists, adj, deg


class SparseMatrix:
    """Dual adjacency-list sparse binary matrix.

    Rows and columns each keep the list of their nonzero partners, in
    insertion order (like sparse.rs:23-26). A set of ``(row, col)`` pairs
    accelerates membership tests.
    """

    __slots__ = (
        "_rows", "_cols", "_entries",
        "_radj", "_rdeg", "_cadj", "_cdeg",
    )

    def __init__(self, nrows: int, ncols: int):
        self._rows: list[list[int]] = [[] for _ in range(nrows)]
        self._cols: list[list[int]] = [[] for _ in range(ncols)]
        self._entries: set[tuple[int, int]] = set()
        # numpy adjacency mirrors (padded with -1, order-free) kept in sync
        # incrementally by insert/remove; they back the vectorized BFS and
        # girth paths, which replace the reference's pointer-chasing BFS
        # (bfs.rs:53-109) with level-synchronous frontier expansion.
        self._radj = np.full((nrows, 4), -1, np.int32)
        self._rdeg = np.zeros(nrows, np.int32)
        self._cadj = np.full((ncols, 4), -1, np.int32)
        self._cdeg = np.zeros(ncols, np.int32)

    # -- numpy mirror bookkeeping -----------------------------------------

    @staticmethod
    def _grow(adj: np.ndarray) -> np.ndarray:
        new = np.full((adj.shape[0], max(4, 2 * adj.shape[1])), -1, np.int32)
        new[:, : adj.shape[1]] = adj
        return new

    def _mirror_add(self, row: int, col: int) -> None:
        rd = int(self._rdeg[row])
        if rd == self._radj.shape[1]:
            self._radj = self._grow(self._radj)
        self._radj[row, rd] = col
        self._rdeg[row] = rd + 1
        cd = int(self._cdeg[col])
        if cd == self._cadj.shape[1]:
            self._cadj = self._grow(self._cadj)
        self._cadj[col, cd] = row
        self._cdeg[col] = cd + 1

    def _mirror_del(self, row: int, col: int) -> None:
        rd = int(self._rdeg[row]) - 1
        sl = self._radj[row]
        i = int(np.nonzero(sl[: rd + 1] == col)[0][0])
        sl[i] = sl[rd]
        sl[rd] = -1
        self._rdeg[row] = rd
        cd = int(self._cdeg[col]) - 1
        sl = self._cadj[col]
        i = int(np.nonzero(sl[: cd + 1] == row)[0][0])
        sl[i] = sl[cd]
        sl[cd] = -1
        self._cdeg[col] = cd

    # -- shape / weights ---------------------------------------------------

    @property
    def num_rows(self) -> int:
        return len(self._rows)

    @property
    def num_cols(self) -> int:
        return len(self._cols)

    def row_weight(self, row: int) -> int:
        return len(self._rows[row])

    def col_weight(self, col: int) -> int:
        return len(self._cols[col])

    def contains(self, row: int, col: int) -> bool:
        return (row, col) in self._entries

    # -- mutation ----------------------------------------------------------

    def insert(self, row: int, col: int) -> None:
        if (row, col) not in self._entries:
            self._rows[row].append(col)
            self._cols[col].append(row)
            self._entries.add((row, col))
            self._mirror_add(row, col)

    def remove(self, row: int, col: int) -> None:
        if (row, col) in self._entries:
            self._rows[row].remove(col)
            self._cols[col].remove(row)
            self._entries.discard((row, col))
            self._mirror_del(row, col)

    def toggle(self, row: int, col: int) -> None:
        if (row, col) in self._entries:
            self.remove(row, col)
        else:
            self.insert(row, col)

    def insert_row(self, row: int, cols: Iterable[int]) -> None:
        for col in cols:
            self.insert(row, col)

    def insert_col(self, col: int, rows: Iterable[int]) -> None:
        for row in rows:
            self.insert(row, col)

    def clear_row(self, row: int) -> None:
        for col in self._rows[row]:
            self._cols[col].remove(row)
            self._entries.discard((row, col))
            self._mirror_del(row, col)
        self._rows[row].clear()

    def clear_col(self, col: int) -> None:
        for row in self._cols[col]:
            self._rows[row].remove(col)
            self._entries.discard((row, col))
            self._mirror_del(row, col)
        self._cols[col].clear()

    def set_row(self, row: int, cols: Iterable[int]) -> None:
        self.clear_row(row)
        self.insert_row(row, cols)

    def set_col(self, col: int, rows: Iterable[int]) -> None:
        self.clear_col(col)
        self.insert_col(col, rows)

    # -- iteration ---------------------------------------------------------

    def iter_all(self) -> Iterator[tuple[int, int]]:
        for j, r in enumerate(self._rows):
            for k in r:
                yield (j, k)

    def iter_row(self, row: int) -> Iterator[int]:
        return iter(self._rows[row])

    def iter_col(self, col: int) -> Iterator[int]:
        return iter(self._cols[col])

    def row_list(self, row: int) -> list[int]:
        return self._rows[row]

    def col_list(self, col: int) -> list[int]:
        return self._cols[col]

    def num_entries(self) -> int:
        return len(self._entries)

    # -- equality (order-insensitive, like sparse.rs:28-47) ----------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, SparseMatrix):
            return NotImplemented
        if self.num_rows != other.num_rows or self.num_cols != other.num_cols:
            return False
        return self._entries == other._entries

    def __hash__(self):  # pragma: no cover - matrices are mutable
        raise TypeError("SparseMatrix is unhashable")

    # -- dense / array conversion -----------------------------------------

    def to_dense(self) -> np.ndarray:
        """Dense 0/1 uint8 array of shape (num_rows, num_cols)."""
        a = np.zeros((self.num_rows, self.num_cols), dtype=np.uint8)
        for r, row in enumerate(self._rows):
            a[r, row] = 1
        return a

    def to_edge_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Edge list as (row_indices, col_indices), sorted by (row, col)."""
        if not self._entries:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        idx = np.array(sorted(self._entries), dtype=np.int64)
        return idx[:, 0], idx[:, 1]

    @classmethod
    def from_dense(cls, a: np.ndarray) -> "SparseMatrix":
        a = np.asarray(a)
        return cls.from_pairs(a.shape[0], a.shape[1], *np.nonzero(a))

    @classmethod
    def from_pairs(cls, nrows: int, ncols: int, rows, cols) -> "SparseMatrix":
        """The matrix with the distinct entries (rows[i], cols[i]) inserted
        in that order: the same adjacency lists and mirrors as ``insert``
        one by one, built in bulk (a dense matrix's row echelon form has
        millions of entries)."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        h = cls(nrows, ncols)
        h._rows, h._radj, h._rdeg = _adjacency(nrows, rows, cols)
        h._cols, h._cadj, h._cdeg = _adjacency(ncols, cols, rows)
        h._entries = set(zip(rows.tolist(), cols.tolist()))
        return h

    # -- alist I/O (byte-compatible with sparse.rs:250-389) ----------------

    def _write_alist(self, use_padding: bool) -> str:
        out: list[str] = []
        out.append(f"{self.num_cols} {self.num_rows}\n")
        directions = [self._cols, self._rows]
        direction_lengths = [
            max((len(el) for el in d), default=0) for d in directions
        ]
        out.append(f"{direction_lengths[0]} {direction_lengths[1]}\n")
        for d in directions:
            out.append(" ".join(str(len(el)) for el in d) + "\n")
        for d, dirlen in zip(directions, direction_lengths):
            for el in d:
                v = sorted(x + 1 for x in el)
                parts = [str(x) for x in v]
                line = " ".join(parts)
                if use_padding:
                    if not v:
                        line += "0"
                    # one padding element was already added if v was empty
                    num_padding = dirlen - max(len(v), 1)
                    line += " 0" * num_padding
                out.append(line + "\n")
        return "".join(out)

    def alist(self) -> str:
        """Alist string with MacKay zero padding for irregular codes."""
        return self._write_alist(True)

    def alist_no_padding(self) -> str:
        """Alist string without zero padding."""
        return self._write_alist(False)

    def write_alist_file(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.alist())

    @classmethod
    def from_alist(cls, alist: str) -> "SparseMatrix":
        """Parse an alist (padded or unpadded; column data is authoritative,
        like the reference parser sparse.rs:352-389)."""
        lines = alist.split("\n")
        if not lines:
            raise ValueError("alist first line not found")
        sizes = lines[0].split()
        if len(sizes) < 2:
            raise ValueError("alist first line does not contain enough elements")
        try:
            ncols, nrows = int(sizes[0]), int(sizes[1])
        except ValueError as e:
            raise ValueError("alist sizes are not numbers") from e
        h = cls(nrows, ncols)
        # lines[1] = max weights, lines[2], lines[3] = per-col/per-row weights
        data = lines[4:]
        if len(data) < ncols:
            raise ValueError("alist does not contain expected number of lines")
        for col in range(ncols):
            for tok in data[col].split():
                try:
                    row = int(tok)
                except ValueError as e:
                    raise ValueError("row value is not a number") from e
                if row != 0:  # 0 is irregular-code padding
                    h.insert(row - 1, col)
        # the rows section is redundant and ignored
        return h

    @classmethod
    def from_alist_file(cls, path) -> "SparseMatrix":
        with open(path) as f:
            return cls.from_alist(f.read())

    # -- BFS / girth (mirrors bfs.rs semantics) ----------------------------

    def _neighbors(self, node: Node) -> Iterator[Node]:
        if node.kind == "row":
            for c in self._rows[node.index]:
                yield Node("col", c)
        else:
            for r in self._cols[node.index]:
                yield Node("row", r)

    def bfs_arrays(self, node: Node) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized BFS distances from ``node``: ``(row_dist, col_dist)``
        int64 arrays with ``-1`` for unreachable nodes.

        Level-synchronous frontier expansion over the numpy adjacency
        mirrors.  Parent exclusion (bfs.rs:14-27) cannot change first-visit
        distances — the parent is always already visited — so this equals
        the reference BFS (bfs.rs:81-93) on every graph.
        """
        dist_r = np.full(self.num_rows, -1, np.int64)
        dist_c = np.full(self.num_cols, -1, np.int64)
        if node.kind == "col":
            dist_c[node.index] = 0
            frontier = np.array([node.index], np.int64)
            side = 1
        else:
            dist_r[node.index] = 0
            frontier = np.array([node.index], np.int64)
            side = 0
        level = 0
        while frontier.size:
            level += 1
            if side == 1:  # cols -> rows
                nb = self._cadj[frontier]
                cand = nb[nb >= 0]
                new = cand[dist_r[cand] < 0]
                if new.size == 0:
                    break
                dist_r[new] = level
                frontier = np.flatnonzero(dist_r == level)
                side = 0
            else:  # rows -> cols
                nb = self._radj[frontier]
                cand = nb[nb >= 0]
                new = cand[dist_c[cand] < 0]
                if new.size == 0:
                    break
                dist_c[new] = level
                frontier = np.flatnonzero(dist_c == level)
                side = 1
        return dist_r, dist_c

    def row_weights_array(self) -> np.ndarray:
        """Per-row weights as an int32 view (mirror-backed, O(1))."""
        return self._rdeg

    def bfs(self, node: Node) -> BFSResults:
        """Breadth-first distances from `node` with parent exclusion."""
        dist_r, dist_c = self.bfs_arrays(node)
        return BFSResults(
            row_nodes_distance=[None if d < 0 else d for d in dist_r.tolist()],
            col_nodes_distance=[None if d < 0 else d for d in dist_c.tolist()],
        )

    def _bfs_deque(self, node: Node) -> BFSResults:
        """Reference-shaped deque BFS (kept for cross-validation tests)."""
        results = BFSResults(
            row_nodes_distance=[None] * self.num_rows,
            col_nodes_distance=[None] * self.num_cols,
        )
        dist = (
            results.row_nodes_distance
            if node.kind == "row"
            else results.col_nodes_distance
        )
        dist[node.index] = 0
        # queue entries: (node, parent, path_length)
        to_visit: deque = deque([(node, None, 0)])
        while to_visit:
            head, parent, plen = to_visit.popleft()
            for nxt in self._neighbors(head):
                if parent is not None and nxt == parent:
                    continue
                d = (
                    results.row_nodes_distance
                    if nxt.kind == "row"
                    else results.col_nodes_distance
                )
                if d[nxt.index] is None:
                    d[nxt.index] = plen + 1
                    to_visit.append((nxt, head, plen + 1))
        return results

    def _local_girth(self, node: Node, max_girth: int) -> int | None:
        """Length of the shortest cycle through ``node`` (as the reference's
        first-revisit rule reports it), or None when no cycle of length
        <= max_girth passes through it (bfs.rs:92-108).

        Vectorized level-synchronous form.  Equivalence with the serial
        FIFO version: on a simple bipartite graph, the first revisit the
        serial BFS encounters is always a "down" edge into a node already
        discovered at the next level during the same level's processing
        (an "up" revisit u->v with v at level q-1 is impossible, because
        whichever level-(q-1) node reached u first became its parent and
        every later one triggered the revisit at level q-1 already), and
        every such revisit found while processing level q has the same
        total 2q+2.  So detecting, per expansion, (a) edges into visited
        non-parent nodes and (b) nodes discovered by more than one edge,
        and returning the minimum total at the first level where any
        occurs, reproduces the serial result exactly (cross-validated
        against the deque implementation in tests/test_sparse.py).
        """
        dist_r = np.full(self.num_rows, -1, np.int64)
        dist_c = np.full(self.num_cols, -1, np.int64)
        par_r = np.full(self.num_rows, -1, np.int64)
        par_c = np.full(self.num_cols, -1, np.int64)
        if node.kind == "col":
            dist_c[node.index] = 0
            frontier = np.array([node.index], np.int64)
            side = 1
        else:
            dist_r[node.index] = 0
            frontier = np.array([node.index], np.int64)
            side = 0
        q = 0
        while frontier.size and (q == 0 or q < max_girth):
            if side == 1:
                nb = self._cadj[frontier]
                dist_o, par_here, par_o = dist_r, par_c, par_r
                n_other = self.num_rows
            else:
                nb = self._radj[frontier]
                dist_o, par_here, par_o = dist_c, par_r, par_c
                n_other = self.num_cols
            valid = nb >= 0
            if not valid.any():
                break
            u = np.broadcast_to(frontier[:, None], nb.shape)[valid]
            v = nb[valid].astype(np.int64)
            nonparent = v != par_here[u]
            u = u[nonparent]
            v = v[nonparent]
            if v.size == 0:
                break
            dv = dist_o[v]
            visited = dv >= 0
            totals = []
            if visited.any():
                totals.append(int((dv[visited] + q + 1).min()))
            newv = v[~visited]
            newu = u[~visited]
            counts = np.bincount(newv, minlength=n_other)
            if (counts[newv] > 1).any():
                totals.append(2 * q + 2)
            if totals:
                total = min(totals)
                return total if total <= max_girth else None
            dist_o[newv] = q + 1
            par_o[newv] = newu
            frontier = newv
            side = 1 - side
            q += 1
        return None

    def _local_girth_deque(self, node: Node, max_girth: int) -> int | None:
        """Serial FIFO local girth, shaped like the reference (kept for
        cross-validation tests of the vectorized form above)."""
        row_dist: list = [None] * self.num_rows
        col_dist: list = [None] * self.num_cols
        if node.kind == "row":
            row_dist[node.index] = 0
        else:
            col_dist[node.index] = 0
        to_visit: deque = deque([(node, None, 0)])
        while to_visit:
            head, parent, plen = to_visit.popleft()
            for nxt in self._neighbors(head):
                if parent is not None and nxt == parent:
                    continue
                d = row_dist if nxt.kind == "row" else col_dist
                cur = d[nxt.index]
                if cur is not None:
                    total = cur + plen + 1
                    return total if total <= max_girth else None
                d[nxt.index] = plen + 1
                if plen + 1 < max_girth:
                    to_visit.append((nxt, head, plen + 1))
        return None

    def girth_at_node_with_max(self, node: Node, max_girth: int) -> int | None:
        return self._local_girth(node, max_girth)

    def girth_at_node(self, node: Node) -> int | None:
        return self._local_girth(node, 2**62)

    def girth_with_max(self, max_girth: int) -> int | None:
        best = None
        bound = max_girth
        for c in range(self.num_cols):
            g = self._local_girth(Node.col(c), bound)
            if g is not None and (best is None or g < best):
                best = g
                # shrink the search bound: cycles in a bipartite graph have
                # even length, so nothing shorter than best-2 can beat best
                bound = min(bound, best)
        return best

    def girth(self) -> int | None:
        return self.girth_with_max(2**62)

    def __repr__(self) -> str:
        return (
            f"SparseMatrix({self.num_rows}x{self.num_cols}, "
            f"{len(self._entries)} ones)"
        )
