"""The edge tables the plain decoders walk, from a lifted code's H.

A check group's edges fall into ``d`` circulants, one per (variable
group, shift); a circulant gives every lane of the group one edge but
where the standard leaves it out (DVB-S2's staircase corner, row 0). The
decoders keep one message per edge of H and address it by the edge's
index into H's (row, column) lists; a lane with no edge in a circulant
points at index ``E`` (a message slot of its own) and at column ``n``.

Orders, which fix the decoders' rounding:

* a check's slots run over its circulants by (variable group, shift);
* a variable's slots run over its circulants by (check group, shift);
* the layered schedule takes the check groups by degree, then by index,
  and adds a group's updates to the posteriors slot by slot.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Graph", "build_graph"]


@dataclass(frozen=True)
class Graph:
    n: int
    E: int  # H's ones
    cols: np.ndarray  # (E,) column of each edge
    #: the check groups in layered order: (edges, cols), each (Z, d)
    layers: tuple
    #: the check lanes of every group by degree: (edges, cols), each (R, d)
    check_buckets: tuple
    #: the variable lanes by degree: (cols (V,), edges (V, d))
    var_buckets: tuple


def _slots(group, key, lane, Z, E):
    """{g: (Z, d) edge table} of the edges grouped by ``group``, their
    slots the sorted distinct ``key`` values of the group, their rows the
    ``lane``; E where a lane has no edge in a slot."""
    order = np.lexsort((lane, key, group))
    g_sorted = group[order]
    bounds = np.flatnonzero(np.diff(g_sorted)) + 1
    out = {}
    for seg in np.split(order, bounds):
        if not len(seg):
            continue
        keys = np.unique(key[seg])
        table = np.full((Z, len(keys)), E, np.int64)
        table[lane[seg], np.searchsorted(keys, key[seg])] = seg
        out[int(group[seg[0]])] = table
    return out


def build_graph(code) -> Graph:
    """The tables of a lifted code: ``code.edges()``, ``code.check_lift``,
    ``code.var_lift`` and its lift size ``Z``."""
    Z = code.Z
    rows, cols = code.edges()
    E, n = len(rows), code.n
    cg, lc = code.check_lift(rows)
    vg, lv = code.var_lift(cols)
    shift = (lc - lv) % Z
    ext_cols = np.append(cols, n)  # edge E: no edge, column n

    checks = _slots(cg, vg * Z + shift, lc, Z, E)
    order = sorted(checks, key=lambda g: (checks[g].shape[1], g))
    layers = tuple((checks[g], ext_cols[checks[g]]) for g in order)
    by_degree: dict = {}
    for g in order:
        by_degree.setdefault(checks[g].shape[1], []).append(checks[g])
    check_buckets = tuple(
        (np.concatenate(ts), ext_cols[np.concatenate(ts)]) for ts in by_degree.values()
    )

    var_tables = _slots(vg, cg * Z + shift, lv, Z, E)
    var_col = np.full((max(var_tables) + 1, Z), -1, np.int64)
    var_col[vg, lv] = cols
    if (var_col < 0).any():
        raise ValueError("the lift does not cover every column")
    by_vdeg: dict = {}
    for g in sorted(var_tables):
        by_vdeg.setdefault(var_tables[g].shape[1], []).append(g)
    var_buckets = tuple(
        (var_col[gs].reshape(-1), np.concatenate([var_tables[g] for g in gs]))
        for _, gs in sorted(by_vdeg.items())
    )
    return Graph(n=n, E=E, cols=cols, layers=layers,
                 check_buckets=check_buckets, var_buckets=var_buckets)
