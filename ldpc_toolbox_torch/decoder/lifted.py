"""Block-circulant (lifted protograph) decode layout (numpy only).

A copy of ``ldpc_toolbox_tpu.decoder.lifted``: the original sits under a
package whose ``__init__`` imports jax, which this package never imports.
``tests/test_torch_layout.py`` holds the two field by field.

Every standards family here is a lifted protograph (SURVEY.md §7): DVB-S2
is a 360-lift (dvbs2.rs:83-97), 5G NR a Z-lift (nr5g.rs:40-53), AR4JA an
M/4-lift with theta/phi quarter-block structure (ccsds.rs:176-188), and C2
a 511-circulant grid (ccsds.rs:353-372). In a lift, H's blocks are sums of
circulants: base edge (vg, cg, s) connects variable lane ``w`` of group
``vg`` to check lane ``(w + s) mod Z`` of group ``cg``.

The decode consequence: messages live as whole planes ``(Z, batch)`` per
base edge, and moving a message between variable and check coordinates is
a *roll* of a contiguous plane — not a row-granular random gather.

``LiftedGraph.from_sparse`` detects the circulant structure from any
parity-check matrix given the (node -> (group, lane)) mappings, verifying
every block is circulant and recording the rare missing lanes (e.g. the
DVB-S2 staircase wrap at row 0) as per-edge lane masks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..sparse import SparseMatrix

__all__ = [
    "LiftedGraph",
    "dvbs2_maps",
    "nr5g_maps",
    "ar4ja_maps",
    "c2_maps",
    "lifted_graph_for",
]


@dataclass(frozen=True)
class _EdgeSide:
    """Per-degree-bucket view of base edges on one side (var or check)."""

    degree: int
    groups: np.ndarray  # (count,) group ids on this side, bucket order
    # (count, degree) plane index into the *opposite* side's message array
    planes: np.ndarray
    # (count, degree) roll amounts to apply to the gathered plane to bring
    # it into this side's lane coordinates
    shifts: np.ndarray
    # check buckets only: (count, degree) bucket-order position of each
    # edge's variable group (for the syndrome pass)
    var_group_pos: np.ndarray = None


@dataclass(frozen=True)
class LiftedGraph:
    Z: int
    n: int  # variable count of the original H
    m: int  # check count
    num_var_groups: int
    num_chk_groups: int
    num_base_edges: int

    # base edge e (var-major order): var group, check group, shift
    edge_vg: np.ndarray
    edge_cg: np.ndarray
    edge_shift: np.ndarray

    # bucketed views: check side gathers from v2c (var-major planes), var
    # side gathers from c2v (check-major planes)
    chk_buckets: tuple  # tuple[_EdgeSide]
    var_buckets: tuple  # tuple[_EdgeSide]

    # chk-major position of each var-major edge (for building c2v order)
    vm_to_cm: np.ndarray

    # original column index per (var group, lane): (num_var_groups, Z)
    var_cols: np.ndarray
    # lane masks: list of (edge_vm_index, lane_array_chk_coords) for edges
    # whose circulant is incomplete; lanes listed are MISSING
    missing: tuple = field(default=())

    # var-group order of the bucketed var side (groups sorted by degree)
    var_group_order: np.ndarray = None
    # for each var group (in bucket order), its bucket row range start
    # handled implicitly by bucket sizes

    @classmethod
    def from_sparse(
        cls,
        h: SparseMatrix,
        var_map: Callable[[int], tuple[int, int]],
        chk_map: Callable[[int], tuple[int, int]],
        Z: int,
        num_var_groups: int,
        num_chk_groups: int,
    ) -> "LiftedGraph":
        n, m = h.num_cols, h.num_rows
        # var_cols[vg, lane] = original column
        var_cols = np.full((num_var_groups, Z), -1, np.int64)
        for v in range(n):
            vg, lv = var_map(v)
            var_cols[vg, lv] = v
        assert (var_cols >= 0).all(), "var_map does not cover all columns"

        # collect edges per (vg, cg, shift)
        blocks: dict[tuple[int, int, int], list[int]] = {}
        for c, v in ((c, v) for c, v in h.iter_all()):
            vg, lv = var_map(v)
            cg, lc = chk_map(c)
            s = (lc - lv) % Z
            blocks.setdefault((vg, cg, s), []).append(lc)
        # base edges sorted var-major: (vg, cg, s)
        keys = sorted(blocks)
        edge_vg = np.array([k[0] for k in keys], np.int64)
        edge_cg = np.array([k[1] for k in keys], np.int64)
        edge_shift = np.array([k[2] for k in keys], np.int64)
        missing = []
        for e, k in enumerate(keys):
            lanes = blocks[k]
            if len(lanes) != Z:
                assert len(set(lanes)) == len(lanes), "duplicate lanes"
                missing_lanes = np.setdiff1d(
                    np.arange(Z), np.asarray(lanes)
                )
                missing.append((e, missing_lanes))
        BE = len(keys)

        # group adjacency (in base-edge var-major order)
        var_adj: dict[int, list[int]] = {}
        chk_adj: dict[int, list[int]] = {}
        for e in range(BE):
            var_adj.setdefault(int(edge_vg[e]), []).append(e)
            chk_adj.setdefault(int(edge_cg[e]), []).append(e)
        for g in range(num_var_groups):
            var_adj.setdefault(g, [])
        for g in range(num_chk_groups):
            chk_adj.setdefault(g, [])

        # chk-major ordering of edges: check groups bucketed by degree
        def buckets_for(adj, count):
            groups: dict[int, list[int]] = {}
            for g in range(count):
                groups.setdefault(len(adj[g]), []).append(g)
            return groups

        chk_groups_by_deg = buckets_for(chk_adj, num_chk_groups)
        var_groups_by_deg = buckets_for(var_adj, num_var_groups)

        # chk-major / var-major (bucket-ordered) position of each base edge
        vm_to_cm = np.empty(BE, np.int64)
        pos = 0
        for d in sorted(chk_groups_by_deg):
            for g in chk_groups_by_deg[d]:
                for e in chk_adj[g]:
                    vm_to_cm[e] = pos
                    pos += 1
        vm_pos = np.empty(BE, np.int64)
        # bucket-order position of each variable group
        vg_pos = np.empty(num_var_groups, np.int64)
        pos = 0
        gpos = 0
        for d in sorted(var_groups_by_deg):
            for g in var_groups_by_deg[d]:
                vg_pos[g] = gpos
                gpos += 1
                for e in var_adj[g]:
                    vm_pos[e] = pos
                    pos += 1

        chk_buckets = []
        for d in sorted(chk_groups_by_deg):
            gs = chk_groups_by_deg[d]
            planes = np.zeros((len(gs), d), np.int32)
            shifts = np.zeros((len(gs), d), np.int32)
            vgp = np.zeros((len(gs), d), np.int32)
            for i, g in enumerate(gs):
                for t, e in enumerate(chk_adj[g]):
                    planes[i, t] = vm_pos[e]  # var-major plane index
                    shifts[i, t] = edge_shift[e]  # roll v->c by +s
                    vgp[i, t] = vg_pos[edge_vg[e]]
            chk_buckets.append(
                _EdgeSide(
                    degree=d,
                    groups=np.asarray(gs, np.int64),
                    planes=planes,
                    shifts=shifts,
                    var_group_pos=vgp,
                )
            )

        var_buckets = []
        for d in sorted(var_groups_by_deg):
            gs = var_groups_by_deg[d]
            planes = np.zeros((len(gs), d), np.int32)
            shifts = np.zeros((len(gs), d), np.int32)
            for i, g in enumerate(gs):
                for t, e in enumerate(var_adj[g]):
                    planes[i, t] = vm_to_cm[e]  # chk-major plane index
                    shifts[i, t] = -edge_shift[e] % Z  # roll c->v by -s
            var_buckets.append(
                _EdgeSide(
                    degree=d,
                    groups=np.asarray(gs, np.int64),
                    planes=planes,
                    shifts=shifts,
                )
            )

        var_group_order = np.concatenate(
            [b.groups for b in var_buckets]
        ) if var_buckets else np.zeros(0, np.int64)

        # missing-lane bookkeeping in both coordinate systems:
        # (vm_plane, chk_lanes) -> chk-side (cm position of edge, lanes) and
        # var-side (vm position, var lanes)
        missing_sided = []
        for e, lanes_c in missing:
            # `missing` lanes were recorded in check-lane coordinates
            lanes_v = (lanes_c - edge_shift[e]) % Z
            missing_sided.append(
                (int(vm_pos[e]), int(vm_to_cm[e]), lanes_c, lanes_v)
            )

        return cls(
            Z=Z,
            n=n,
            m=m,
            num_var_groups=num_var_groups,
            num_chk_groups=num_chk_groups,
            num_base_edges=BE,
            edge_vg=edge_vg,
            edge_cg=edge_cg,
            edge_shift=edge_shift,
            chk_buckets=tuple(chk_buckets),
            var_buckets=tuple(var_buckets),
            vm_to_cm=vm_to_cm,
            var_cols=var_cols,
            missing=tuple(missing_sided),
            var_group_order=var_group_order,
        )


# -- per-family (group, lane) mappings --------------------------------------


def dvbs2_maps(code):
    """DVB-S2: info columns 360-lifted by column groups; parity columns and
    rows q-grouped (row r = a + b*q -> group a, lane b)."""
    k, q, Z = code.k, code.q, 360
    kg = k // 360

    def var_map(j):
        if j < k:
            return (j // 360, j % 360)
        r = j - k
        return (kg + r % q, r // q)

    def chk_map(r):
        return (r % q, r // q)

    return var_map, chk_map, Z, kg + q, q


def nr5g_maps(bg, z):
    """5G NR: contiguous Z-blocks on both axes (nr5g.rs:40-53)."""

    def var_map(j):
        return (j // z, j % z)

    def chk_map(r):
        return (r // z, r % z)

    return var_map, chk_map, z, bg.num_cols, bg.num_rows


def ar4ja_maps(code):
    """AR4JA: each MxM protograph block splits into 4 quarter-circulants of
    size M/4 (pi(k,i) maps quarters by theta and rotates by phi,
    ccsds.rs:176-188)."""
    M = code.m_size
    quarter = M // 4

    def var_map(j):
        return (j // quarter, j % quarter)

    def chk_map(r):
        return (r // quarter, r % quarter)

    h_cols = {
        "R1_2": 5,
        "R2_3": 7,
        "R4_5": 11,
    }[code.rate.name]
    return var_map, chk_map, quarter, h_cols * 4, 3 * 4


def c2_maps():
    """C2: a 2x16 grid of 511-circulants."""
    N = 511

    def var_map(j):
        return (j // N, j % N)

    def chk_map(r):
        return (r // N, r % N)

    return var_map, chk_map, N, 16, 2


def lifted_graph_for(code_obj) -> Optional[LiftedGraph]:
    """Build a LiftedGraph for a known standards code object."""
    from ..codes.ccsds import AR4JACode, C2Code
    from ..codes.dvbs2 import Code as DvbCode

    if isinstance(code_obj, DvbCode):
        vm, cm, Z, nvg, ncg = dvbs2_maps(code_obj)
        return LiftedGraph.from_sparse(code_obj.h(), vm, cm, Z, nvg, ncg)
    if isinstance(code_obj, AR4JACode):
        vm, cm, Z, nvg, ncg = ar4ja_maps(code_obj)
        return LiftedGraph.from_sparse(code_obj.h(), vm, cm, Z, nvg, ncg)
    if isinstance(code_obj, C2Code):
        vm, cm, Z, nvg, ncg = c2_maps()
        return LiftedGraph.from_sparse(code_obj.h(), vm, cm, Z, nvg, ncg)
    return None
