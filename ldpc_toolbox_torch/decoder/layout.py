"""Padded dual-gather decode layout of a generic parity-check matrix.

A copy of ``ldpc_toolbox_tpu.decoder.layout`` (numpy only), kept so that
this package imports nothing of the JAX package;
``tests/test_torch_generic.py`` holds the two equal field by field.

The Tanner graph compiles to static index tables, and one BP iteration is
two gathers over message arrays:

* the padded tables: variable-major ``v2c`` slots ``(n, dv_max)`` and
  check-major ``c2v`` slots ``(m, dc_max)`` with masks, the padded slots
  pointing at a sentinel (the layered schedule's layout);
* the compact bucketed layout: variables and checks each reordered by
  (degree, original index), messages in exact ``(num_edges, batch)``
  arrays, one gather a degree bucket a phase (the flooding schedule's).

Batch is the trailing dimension, so every gather moves contiguous
``(batch,)`` rows. The horizontal-layered schedule also needs groups of
variable-disjoint checks ("layers"); :func:`extract_layers` layers the
row-conflict graph so that the schedule equals the reference's serial
0..m sweep.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..sparse import SparseMatrix

__all__ = ["DecodeGraph", "Bucket", "extract_layers"]


@dataclass(frozen=True)
class Bucket:
    """A group of same-degree nodes in the compact bucketed layout.

    ``edges[i, s]`` is the flat message-array index of node i's s-th edge
    in the *opposite* side's message array; ``ids`` are original node
    indices (row ``i`` of this bucket is node ``ids[i]``). ``vars`` is only
    set for check buckets: the bucket-reordered variable index per slot,
    used for the syndrome check.
    """

    degree: int
    ids: np.ndarray  # (count,) original node index
    edges: np.ndarray  # (count, degree) flat index into the opposite array
    vars: np.ndarray = None  # (count, degree), check buckets only


@dataclass(frozen=True)
class DecodeGraph:
    """Static index tensors compiled from a parity-check matrix."""

    m: int  # number of check nodes (rows)
    n: int  # number of variable nodes (cols)
    num_edges: int
    dc_max: int  # max check degree
    dv_max: int  # max variable degree

    # (m, dc_max): variable index per check slot; padding -> n
    chk_vars: np.ndarray
    # (m, dc_max): var-major edge id per check slot; padding -> n*dv_max
    chk_edges: np.ndarray
    # (m, dc_max) bool
    chk_mask: np.ndarray
    # (n, dv_max): check index per var slot; padding -> m
    var_chks: np.ndarray
    # (n, dv_max): chk-major edge id per var slot; padding -> m*dc_max
    var_edges: np.ndarray
    # (n, dv_max) bool
    var_mask: np.ndarray

    # layered schedule: (num_layers, rows_per_layer) row ids; padding -> m
    layers: np.ndarray = field(default=None)

    # -- compact bucketed layout (flooding fast path) ----------------------
    # Variables and checks are each reordered by (degree, original index);
    # messages then live in exact (num_edges, batch) arrays — v2c in
    # variable-major bucket order, c2v in check-major bucket order — with
    # no padding slots, no masks and no sentinel rows.
    var_buckets: tuple = field(default=None)  # tuple[Bucket]
    chk_buckets: tuple = field(default=None)  # tuple[Bucket]
    var_order: np.ndarray = field(default=None)  # (n,) original id per new pos
    inv_var_order: np.ndarray = field(default=None)  # (n,) new pos per orig id

    @classmethod
    def from_sparse(
        cls, h: SparseMatrix, build_layers: bool = True
    ) -> "DecodeGraph":
        m, n = h.num_rows, h.num_cols
        rows = [h.row_list(r) for r in range(m)]
        cols = [h.col_list(c) for c in range(n)]
        dc_max = max((len(r) for r in rows), default=1) or 1
        dv_max = max((len(c) for c in cols), default=1) or 1

        # slot position of check c within variable v's adjacency list, and
        # of variable v within check c's list (adjacency insertion order is
        # preserved — it is the reference's message fold order)
        pos_in_col = [{c: s for s, c in enumerate(col)} for col in cols]
        pos_in_row = [{v: t for t, v in enumerate(row)} for row in rows]

        chk_vars = np.full((m, dc_max), n, dtype=np.int32)
        chk_edges = np.full((m, dc_max), n * dv_max, dtype=np.int32)
        chk_mask = np.zeros((m, dc_max), dtype=bool)
        for c, row in enumerate(rows):
            for t, v in enumerate(row):
                chk_vars[c, t] = v
                chk_edges[c, t] = v * dv_max + pos_in_col[v][c]
                chk_mask[c, t] = True

        var_chks = np.full((n, dv_max), m, dtype=np.int32)
        var_edges = np.full((n, dv_max), m * dc_max, dtype=np.int32)
        var_mask = np.zeros((n, dv_max), dtype=bool)
        for v, col in enumerate(cols):
            for s, c in enumerate(col):
                var_chks[v, s] = c
                var_edges[v, s] = c * dc_max + pos_in_row[c][v]
                var_mask[v, s] = True

        layers = extract_layers(rows, cols, m) if build_layers else None

        # -- compact bucketed layout --------------------------------------
        def order_by_degree(adj):
            groups: dict[int, list[int]] = {}
            for i, a in enumerate(adj):
                groups.setdefault(len(a), []).append(i)
            order = [i for d in sorted(groups) for i in groups[d]]
            return groups, np.asarray(order, np.int64)

        var_groups, var_order = order_by_degree(cols)
        chk_groups, chk_order = order_by_degree(rows)
        inv_var_order = np.empty(n, np.int64)
        inv_var_order[var_order] = np.arange(n)

        # flat edge ids in each message array
        v2c_id = {}  # (c, v) -> index in the v2c array
        off = 0
        for d in sorted(var_groups):
            for v in var_groups[d]:
                for s, c in enumerate(cols[v]):
                    v2c_id[(c, v)] = off + s
                off += d
        c2v_id = {}  # (c, v) -> index in the c2v array
        off = 0
        for d in sorted(chk_groups):
            for c in chk_groups[d]:
                for t, v in enumerate(rows[c]):
                    c2v_id[(c, v)] = off + t
                off += d

        var_buckets = []
        for d in sorted(var_groups):
            ids = np.asarray(var_groups[d], np.int64)
            edges = np.empty((len(ids), max(d, 1)), np.int32)
            if d == 0:
                edges = np.zeros((len(ids), 0), np.int32)
            else:
                for i, v in enumerate(var_groups[d]):
                    for s, c in enumerate(cols[v]):
                        edges[i, s] = c2v_id[(c, v)]
            var_buckets.append(Bucket(degree=d, ids=ids, edges=edges))

        chk_buckets = []
        for d in sorted(chk_groups):
            ids = np.asarray(chk_groups[d], np.int64)
            if d == 0:
                edges = np.zeros((len(ids), 0), np.int32)
                vars_ = np.zeros((len(ids), 0), np.int32)
            else:
                edges = np.empty((len(ids), d), np.int32)
                vars_ = np.empty((len(ids), d), np.int32)
                for i, c in enumerate(chk_groups[d]):
                    for t, v in enumerate(rows[c]):
                        edges[i, t] = v2c_id[(c, v)]
                        vars_[i, t] = inv_var_order[v]
            chk_buckets.append(Bucket(degree=d, ids=ids, edges=edges, vars=vars_))

        return cls(
            m=m,
            n=n,
            num_edges=sum(len(r) for r in rows),
            dc_max=dc_max,
            dv_max=dv_max,
            chk_vars=chk_vars,
            chk_edges=chk_edges,
            chk_mask=chk_mask,
            var_chks=var_chks,
            var_edges=var_edges,
            var_mask=var_mask,
            layers=layers,
            var_buckets=tuple(var_buckets),
            chk_buckets=tuple(chk_buckets),
            var_order=var_order,
            inv_var_order=inv_var_order,
        )


def extract_layers(
    rows: list[list[int]], cols: list[list[int]], m: int
) -> np.ndarray:
    """Order-preserving layering of the row-conflict graph (rows conflict
    iff they share a variable). Row ``r`` is assigned layer
    ``1 + max(layer of every conflicting row before it)``, so

    * within a layer all checks are variable-disjoint — the parallel
      update equals any serial order of the layer's rows; and
    * every conflicting pair executes in increasing row index — the whole
      schedule is *serial-equivalent to the reference's 0..m sweep*
      (horizontal_layered.rs:49-110): identical messages, posteriors,
      hard decisions and iteration counts, bit-for-bit for the integer
      arithmetics.

    This yields more layers than a smallest-feasible-color greedy coloring
    (longest conflict chain vs chromatic number) but buys exact reference
    semantics; the structured families (DVB-S2 / 5G NR / AR4JA) use the
    lifted base-row schedule instead, where layers are the natural lift
    groups. Returns an int32 array (num_layers, rows_per_layer) padded
    with ``m``.
    """
    colors = np.full(m, -1, dtype=np.int64)
    # highest layer index used by any earlier row adjacent to each variable
    var_max_color = np.full(len(cols), -1, dtype=np.int64)
    for r, row in enumerate(rows):
        c = 0
        for v in row:
            if var_max_color[v] >= c:
                c = var_max_color[v] + 1
        colors[r] = c
        for v in row:
            var_max_color[v] = max(var_max_color[v], c)

    num_layers = int(colors.max()) + 1 if m else 1
    groups: list[list[int]] = [[] for _ in range(num_layers)]
    for r in range(m):
        groups[colors[r]].append(r)
    width = max(len(g) for g in groups)
    layers = np.full((num_layers, width), m, dtype=np.int32)
    for i, g in enumerate(groups):
        layers[i, : len(g)] = g
    return layers
