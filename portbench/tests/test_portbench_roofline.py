"""The roofline arithmetic of ``roofline/minsum.py`` on the two codes,
from the reference's own tables, against values worked by hand."""

import pytest

from portbench import lookup, peaks
from portbench.reference import dvbs2
from portbench.reference.graph import build_graph

MINSUM = lookup.roofline("minsum")


@pytest.mark.parametrize("spec, ones, lanes, n", [
    # 630 base edges x Z = 360 = 226,800 lanes of the lift; H misses one
    # (row 0's staircase corner)
    ("dvbs2:1/2", 226_799, 90 * 360 * 7, 64_800),
    ("dvbs2:3/5", 285_119, 72 * 360 * 11, 64_800),
])
def test_edges_of_the_codes(spec, ones, lanes, n):
    graph = build_graph(dvbs2.code(spec))
    assert graph.E == ones
    assert sum(edges.size for edges, _ in graph.layers) == lanes
    assert graph.n == n


def test_layered_r1_2_at_full_iterations():
    # 1024 frames x 30 iterations: (226,799 x (11 + 3 + 1) + 64,800) an
    # iteration = 3,466,785; 30,720 x 3,466,785 = 106,499,635,200; the
    # iteration-0 syndrome 1024 x 226,799 = 232,242,176
    ops = MINSUM.operations("layered", 226_799, 64_800, 30 * 1024, 1024)
    assert ops == 106_731_877_376
    nbytes = MINSUM.bytes_moved(64_800, 1024)
    assert nbytes == 1024 * (64_800 * 5 + 5) == 331_781_120
    seconds, by = MINSUM.least_seconds(ops, nbytes, peaks.F32_OPS_PER_S,
                                       peaks.HBM_BYTES_PER_S)
    assert by == "operations"
    assert seconds == pytest.approx(1.59301e-3, rel=1e-5)


def test_flooding_r3_5_counts_each_frames_iterations():
    # frames that ran 30, 0, 12 and 5 iterations: 47 in all, (285,119 x
    # (11 + 2 + 1) + 64,800) = 4,056,466 each, and 4 x 285,119 more
    frames = [30, 0, 12, 5]
    ops = MINSUM.operations("flooding", 285_119, 64_800, sum(frames), len(frames))
    assert ops == 191_794_378
    assert MINSUM.bytes_moved(64_800, 4) == 1_296_020

