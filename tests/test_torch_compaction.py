"""Staged converged-frame compaction (``decoder/compaction.py``) on the CPU,
without the JAX package: the stage sizes, the frame permutation on a
decode whose frames converge at known iterations, and the streaming decodes
of both schedules (plain versions under staged compaction) against the
resident plain versions, bit for bit."""

import numpy as np
import pytest
import torch

from ldpc_toolbox_torch.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_torch.codes.nr5g import BaseGraph
from ldpc_toolbox_torch.decoder.compaction import stage_sizes, staged_while_decode
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted import LiftedGraph, lifted_graph_for, nr5g_maps
from ldpc_toolbox_torch.decoder.lifted_flooding import (
    flooding_tiles,
    streaming_flooding_decode,
)
from ldpc_toolbox_torch.decoder.lifted_layered import (
    streaming_layered_decode,
    tile_inputs,
)
from ldpc_toolbox_torch.ops.resident_flooding import resident_flooding_decode_reference
from ldpc_toolbox_torch.ops.resident_layered import resident_layered_decode_reference

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "nbt,sizes",
    [
        (1, [1]),
        (2, [2, 1]),
        (33, [33, 17, 9, 5, 3, 2, 1]),
        (256, [256, 128, 64, 32, 16, 8, 4, 2, 1]),
    ],
)
def test_stage_sizes(nbt, sizes):
    assert stage_sizes(nbt) == sizes


def test_permutation_and_freeze():
    """Frame f converges at iteration target[f] (never, above the budget):
    every frame comes back to its own place with its own bits, count and
    flag, frames leave the active tiles only once converged, and each stage
    runs on the tiles of its size."""
    nbt, bt, budget = 9, 4, 12
    B = nbt * bt
    rng = np.random.default_rng(3)
    target = torch.from_numpy(rng.integers(0, budget + 4, B))
    tiles_seen = []

    def planes(frames):
        """Each frame's bits spell its id: (t, 1, 2, bt) int8."""
        code = torch.stack([frames % 100, frames // 100], dim=1)
        return code.to(torch.int8).reshape(-1, bt, 1, 2).permute(0, 2, 3, 1).contiguous()

    def decode_frames(bits):
        return (bits[:, 0, 0, :].long() + 100 * bits[:, 0, 1, :].long()).reshape(-1)

    def iteration(state, const):
        (frames,) = const
        tiles_seen.append(frames.shape[0])
        return state, planes(frames[:, 0, 0, :].reshape(-1))

    def syndrome(bits):
        frames = decode_frames(bits)
        return (target[frames] > counter[0]).to(torch.int32).reshape(-1, bt)

    counter = [0]

    def counted(state, const):
        counter[0] += 1
        return iteration(state, const)

    ids = torch.arange(B)
    const = ids.to(torch.int32).reshape(nbt, bt, 1, 1).permute(0, 2, 3, 1).contiguous()
    bits0 = planes(ids)
    bits0[:] = 0  # frame 0's code: target-0 frames must keep these bits
    # iteration 0 tests bits0 (frame id 0 for every frame): pass only the
    # frames whose own target is 0
    zero = (target == 0).reshape(nbt, bt).to(torch.int32)

    def syndrome0(bits):
        if counter[0] == 0:
            return 1 - zero
        return syndrome(bits)

    bits, iters, conv = staged_while_decode(
        max_iterations=budget, state=(), const=(const,), bits0=bits0,
        iteration=counted, syndrome=syndrome0,
    )
    conv, iters = conv.reshape(-1).bool(), iters.reshape(-1)
    expect_conv = target <= budget
    assert torch.equal(conv, expect_conv)
    assert torch.equal(iters, torch.where(expect_conv, target, budget).to(torch.int32))
    got = decode_frames(bits)
    # converged frames hold the bits of their passing iteration (their own
    # id), target-0 frames the raw bits, the others their last bits (own id)
    assert torch.equal(got, torch.where(target == 0, 0, ids))
    assert counter[0] == budget
    assert tiles_seen == sorted(tiles_seen, reverse=True)
    assert set(tiles_seen) <= set(stage_sizes(nbt)) and len(set(tiles_seen)) > 2


def _llrs(n, batch, sigma, seed):
    rng = np.random.default_rng(seed)
    x = -1.0 + sigma * rng.standard_normal((batch, n))
    return torch.from_numpy(((-2.0 / sigma**2) * x).astype(np.float32))


def _graph(code):
    if code == "bg2z16":
        bg = BaseGraph.BG2
        return LiftedGraph.from_sparse(bg.h(16), *nr5g_maps(bg, 16))
    return lifted_graph_for(DvbCode.R1_4short)


#: (code, schedule) -> (batch, sigma, iterations): a mix of frames that
#: converge at three or more iterations and frames that fail
CASES = {
    ("bg2z16", "layered"): (256, 1.3, 6),
    ("bg2z16", "flooding"): (256, 1.3, 8),
    ("R1_4short", "layered"): (128, 1.05, 8),
    ("R1_4short", "flooding"): (128, 0.85, 8),
}


@pytest.mark.parametrize("code,schedule", list(CASES))
def test_streaming_equals_resident_plain(code, schedule):
    batch, sigma, iters = CASES[code, schedule]
    lg = _graph(code)
    x = _llrs(lg.n, batch, sigma, seed=11)
    if schedule == "layered":
        args = tile_inputs(lg, make_arithmetic("HLMinsumbf16")[1], x)
        stream = streaming_layered_decode(*args, iters)
        ref = resident_layered_decode_reference(*args, iters)
    else:
        args = flooding_tiles(lg, make_arithmetic("Minsumbf16")[1], x)
        stream = streaming_flooding_decode(*args, iters)
        ref = resident_flooding_decode_reference(*args, iters)
    for a, b in zip(stream, ref):
        assert torch.equal(a, b)
    conv, its = ref[2].reshape(-1).bool(), ref[1].reshape(-1)
    assert 0 < int(conv.sum()) < conv.numel()
    assert len(set(its[conv].tolist())) >= 3
