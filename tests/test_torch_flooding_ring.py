"""The host side of the min-sum resident flooding kernel's ring
(``csrc/flooding_ring.cuh``): the stage size ``ring_stage_bytes`` gives for
every code the registry builds fits two blocks an SM of an H100 beside
the layout tables, and every item of each pass, cut as the kernel cuts
them (the check pass's runs of check lanes where they apply, else runs of
whole groups and chunks of a group's lanes), fits a stage and the items
cover every group's lanes once; a card with too little shared memory is
refused."""

import dataclasses

import pytest

from ldpc_toolbox_torch.codes.ccsds import AR4JACode, AR4JAInfoSize, AR4JARate, C2Code
from ldpc_toolbox_torch.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_torch.codes.nr5g import LIFTING_SIZES, BaseGraph
from ldpc_toolbox_torch.decoder import lifted_layered
from ldpc_toolbox_torch.decoder.lifted import LiftedGraph, lifted_graph_for, nr5g_maps
from ldpc_toolbox_torch.ops.resident_flooding import (
    RING_HEAD_BYTES,
    RING_STAGES,
    _window_bytes,
    _wrapped_bytes,
    ring_stage_bytes,
)
from ldpc_toolbox_torch.ops.resident_layered import BT, LANE_THREADS, shared_ints

#: an H100 SM's shared memory, and what the card keeps of it a block
#: (``ldpc_ring_block_bytes`` reads 115,712 for a block, two an SM)
H100_SM_BYTES = 233_472
H100_RESERVED_BYTES = 1024
H100_BLOCK_BYTES = H100_SM_BYTES // 2 - H100_RESERVED_BYTES

AR4JA = [(r, k) for r in AR4JARate for k in AR4JAInfoSize]


def _items(cs, Z, stage, whole, lanes):
    """The items of a pass as ``ring::Cursor`` walks them: (a, b, l0, n)."""
    G, g, l0 = len(cs) - 1, 0, 0
    while g < G:
        if l0 == 0 and whole(g, g + 1) <= stage:
            b = g + 1
            while b < G and whole(g, b + 1) <= stage:
                b += 1
            yield g, b, 0, Z
            g = b
        else:
            n = min(max(1, lanes(cs[g + 1] - cs[g])), Z - l0)
            yield g, g + 1, l0, n
            l0 += n
            if l0 >= Z:
                g, l0 = g + 1, 0


def _runs(R, L, Z):
    """The check pass's runs as ``ring::Runs`` walks them: (a, b, l0, n)."""
    for r in range(0, R, L):
        n = min(L, R - r)
        yield r // Z, (r + n - 1) // Z + 1, r % Z, n


def _floor16(b):
    return b // 16 * 16


def _row_bytes(n, Z, lb):
    """A rotated row's slot (``ring::row_bytes``): whole, or a chunk that
    may wrap."""
    return _window_bytes(Z, lb) if n == Z else _wrapped_bytes(n, lb)


def _check_plan(layout, itemsize):
    """Holds the stage and every pass's items of a layout to a block's
    shared memory (the kernel's own formulas, ``flooding_ring_kernel``)."""
    S = ring_stage_bytes(layout, itemsize, H100_BLOCK_BYTES)
    assert S % 128 == 0
    smem = 4 * shared_ints(layout, False) + RING_HEAD_BYTES + RING_STAGES * S
    assert 2 * (smem + H100_RESERVED_BYTES) <= H100_SM_BYTES
    Z, lb = layout.Z, BT * itemsize
    ccs = layout.chk_cs.tolist() + [layout.E]
    vcs = layout.var_cs.tolist() + [layout.E]
    passes = {
        "check": (ccs, lambda a, b: _window_bytes((ccs[b] - ccs[a]) * Z, lb),
                  lambda d: _floor16(S // d - 16) // lb,
                  lambda a, b, n: _window_bytes((ccs[b] - ccs[a]) * Z, lb) if n == Z
                  else (ccs[b] - ccs[a]) * _window_bytes(n, lb)),
        "variable": (vcs, lambda a, b: _window_bytes((b - a) * Z, lb)
                     + (vcs[b] - vcs[a]) * _window_bytes(Z, lb),
                     lambda d: _floor16((S - 16 - 48 * d) // (1 + d)) // lb,
                     lambda a, b, n: _window_bytes((b - a) * n, lb)
                     + (vcs[b] - vcs[a]) * _row_bytes(n, Z, lb)),
        "syndrome": (ccs, lambda a, b: (ccs[b] - ccs[a]) * _window_bytes(Z, BT),
                     lambda d: _floor16(S // d - 48) // BT,
                     lambda a, b, n: (ccs[b] - ccs[a]) * _row_bytes(n, Z, BT)),
    }
    # the check pass in runs of whole rounds of a block's threads where one
    # fits a stage (``ring::run_lanes``): each run within kParts = 3 groups
    dc = layout.max_chk_degree
    fit = min(_floor16(S // dc - 80) // lb, 2 * Z + 1)
    if fit >= LANE_THREADS:
        L = fit // LANE_THREADS * LANE_THREADS
        covered = 0
        for a, b, l0, n in _runs(layout.CG * Z, L, Z):
            assert b - a <= 3 and a * Z + l0 == covered
            r0 = a * Z + l0
            parts = [(g, max(r0, g * Z) - g * Z, min(r0 + n, (g + 1) * Z) - g * Z)
                     for g in range(a, b)]
            assert sum(ccs[g + 1] - ccs[g] for g, _, _ in parts) == ccs[b] - ccs[a]
            assert sum((ccs[g + 1] - ccs[g]) * _window_bytes(hi - lo, lb)
                       for g, lo, hi in parts) <= S, ("check runs", a, b, l0, n)
            covered += n
        assert covered == layout.CG * Z
        del passes["check"]
    for name, (cs, whole, lanes, need) in passes.items():
        covered = [0] * (len(cs) - 1)
        for a, b, l0, n in _items(cs, Z, S, whole, lanes):
            assert n >= 1 and need(a, b, n) <= S, (name, a, b, l0, n)
            for g in range(a, b):
                assert covered[g] == l0, (name, g)
                covered[g] += n
        assert covered == [Z] * (len(cs) - 1), name
    return S


def _layout(lg):
    return lifted_layered.device_layout(lg, "cpu")


@pytest.mark.parametrize("code", list(DvbCode), ids=lambda c: c.name)
def test_ring_plan_fits_dvbs2(code):
    layout = _layout(lifted_graph_for(code))
    for itemsize in (2, 4):
        _check_plan(layout, itemsize)
    if code == DvbCode.R3_5:
        # the benchmark's 8PSK cells: a whole check group (11 rows of 2880
        # bytes) and a whole variable group of degree 12 with its q row a
        # stage, in bf16
        assert ring_stage_bytes(layout, 2, H100_BLOCK_BYTES) == 37_760


@pytest.mark.parametrize("bg", list(BaseGraph), ids=lambda b: b.name)
def test_ring_plan_fits_5g_every_lifting_size(bg):
    """Every lifting size of a base graph: the tables and the degrees do not
    depend on Z, so the layout of Z = 2 serves with its Z replaced; Z = 384
    held against a layout built at that size."""
    small = _layout(LiftedGraph.from_sparse(bg.h(2), *nr5g_maps(bg, 2)))
    for z in LIFTING_SIZES:
        for itemsize in (2, 4):
            _check_plan(dataclasses.replace(small, Z=z), itemsize)
    big = _layout(LiftedGraph.from_sparse(bg.h(384), *nr5g_maps(bg, 384)))
    for itemsize in (2, 4):
        assert _check_plan(big, itemsize) == _check_plan(
            dataclasses.replace(small, Z=384), itemsize)


@pytest.mark.parametrize("rate,size", AR4JA, ids=lambda x: x.name)
def test_ring_plan_fits_ar4ja(rate, size):
    layout = _layout(lifted_graph_for(AR4JACode(rate, size)))
    for itemsize in (2, 4):
        _check_plan(layout, itemsize)


def test_ring_plan_fits_ccsds_c2():
    """C2: Z = 511, odd, so a bf16 row is no whole number of 16-byte rows;
    its check groups (degree 32) and hard-bit rows go in chunks."""
    layout = _layout(lifted_graph_for(C2Code()))
    for itemsize in (2, 4):
        S = _check_plan(layout, itemsize)
        assert layout.max_chk_degree * _window_bytes(layout.Z, BT) > S


def test_ring_plan_refuses_a_block_too_small():
    """A block whose shared memory holds the tables but not two stages of
    one lane of the largest group is refused; one more 128-byte row a stage
    is taken."""
    layout = _layout(lifted_graph_for(DvbCode.R1_4short))
    tables = 4 * shared_ints(layout, False) + RING_HEAD_BYTES
    lb, dc = BT * 2, layout.max_chk_degree
    dv = max(m.d for m in layout.var_meta)
    least = max(dc * _window_bytes(1, lb), _window_bytes(1, lb) + dv * _wrapped_bytes(1, lb),
                dc * _wrapped_bytes(1, BT))
    least = -(-least // 128) * 128
    with pytest.raises(ValueError, match="do not fit"):
        ring_stage_bytes(layout, 2, tables + RING_STAGES * least - 1)
    assert ring_stage_bytes(layout, 2, tables + RING_STAGES * least) == least
