"""The CUDA kernel against its plain version, bit for bit, on the card.

This file imports no jax (the machine with the card has none), so it runs
there without the repository's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted import (
    LiftedGraph,
    lifted_graph_for,
    nr5g_maps,
)
from ldpc_toolbox_torch.decoder.lifted_layered import (
    lifted_layered_decode,
    plain_layered_decode,
    tile_inputs,
)
from ldpc_toolbox_torch.ops.resident_layered import (
    resident_layered_decode,
    resident_layered_decode_reference,
)

pytestmark = pytest.mark.cuda
DECODERS = ["HLMinsumf32", "HLMinsumbf16", "HLNormminsumbf16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _llrs(n, batch, sigma, seed, device):
    rng = np.random.default_rng(seed)
    x = -1.0 + sigma * rng.standard_normal((batch, n))
    return torch.as_tensor((-2.0 / sigma**2) * x, dtype=torch.float32, device=device)


@pytest.mark.parametrize("decoder", DECODERS)
def test_kernel_matches_plain_version(cuda, decoder):
    """R1_4short (two edges into one variable group in four check groups,
    a missing lane), 8 iterations."""
    lg = lifted_graph_for(DvbCode.R1_4short)
    _, arith = make_arithmetic(decoder)
    args = tile_inputs(lg, arith, _llrs(lg.n, 128, 1.05, 5, cuda))
    before = resident_layered_decode.launches
    out = resident_layered_decode(*args, 8)
    assert resident_layered_decode.launches == before + 1
    ref = resident_layered_decode_reference(*args, 8)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert 0 < int(out[2].sum()) < out[2].numel()


def test_partial_tile_decode_matches_plain(cuda):
    """A batch that is no multiple of the tile, through the glue."""
    bg, z = BaseGraph.BG2, 16
    lg = LiftedGraph.from_sparse(bg.h(z), *nr5g_maps(bg, z))
    _, arith = make_arithmetic("HLMinsumbf16")
    llrs = _llrs(lg.n, 130, 1.3, 11, cuda)
    out = lifted_layered_decode(lg, arith, llrs, 10)
    ref = plain_layered_decode(lg, arith, llrs, 10)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], ref[key]), key
