"""The CUDA kernels against their plain versions, bit for bit, on the card.

This file imports no jax (the machine with the card has none), so it runs
there without the repository's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips.
"""

import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ldpc_toolbox_torch import telemetry
from ldpc_toolbox_torch.codes.ccsds import C2Code
from ldpc_toolbox_torch.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_torch.codes.nr5g import BaseGraph
from ldpc_toolbox_torch.decoder import Decoder, lifted_decode_for, lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted_flooding import (
    flooding_tiles,
    lifted_flooding_decode,
)
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
from ldpc_toolbox_torch.ops import fused_bp2
from ldpc_toolbox_torch.ops import fused_layered as fused_layered_ops
from ldpc_toolbox_torch.ops.fused_layered import (
    fused_layered_iteration,
    fused_layered_iteration_reference,
)
from ldpc_toolbox_torch.ops.resident_compressed import (
    compressed_flooding_decode,
    compressed_flooding_decode_reference,
    compressed_layered_decode,
    compressed_layered_decode_reference,
)
from ldpc_toolbox_torch.ops.resident_flooding import (
    resident_flooding_decode,
    resident_flooding_decode_float,
    resident_flooding_decode_i8,
    resident_flooding_decode_reference,
)
from ldpc_toolbox_torch.ops.resident_layered import (
    resident_layered_decode,
    resident_layered_decode_float,
    resident_layered_decode_i8,
    resident_layered_decode_reference,
)
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.simulation.ber import step_generator
from ldpc_toolbox_torch.sparse import SparseMatrix

pytestmark = pytest.mark.cuda
DECODERS = ["HLMinsumf32", "HLMinsumbf16", "HLNormminsumbf16"]
FLOODING = ["Minsumf32", "Minsumbf16", "Normminsumbf16"]
#: the compressed kernels' f32, bf16 and normalized names of both schedules
COMPRESSED = [
    "HLMinsumf32", "HLMinsumbf16", "HLNormminsumf32",
    "Minsumf32", "Minsumbf16", "Normminsumf32",
]


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


def _flooding_case(decoder, device):
    """R1_4short tiles (two check buckets, three variable buckets, missing
    lanes) at an Eb/N0 where some frames converge within 6 iterations."""
    lg = lifted_graph_for(DvbCode.R1_4short)
    _, arith = make_arithmetic(decoder)
    return lg, flooding_tiles(lg, arith, _llrs(lg.n, 128, 0.85, 5, device))


@pytest.mark.parametrize("decoder", FLOODING)
def test_flooding_phase_kernels_match_plain_versions(cuda, decoder):
    _, (q, bits0, layout, rule) = _flooding_case(decoder, cuda)
    before = (fused_bp2.fused_check.launches, fused_bp2.fused_var.launches,
              fused_bp2.fused_syndrome_bits.launches)
    v2c0, b0 = fused_bp2.fused_var(None, q, layout, rule)
    r_v2c0, r_b0 = fused_bp2.fused_var_reference(None, q, layout, rule)
    assert torch.equal(v2c0, r_v2c0) and torch.equal(b0, r_b0)
    c2v = fused_bp2.fused_check(v2c0, layout, rule)
    assert torch.equal(c2v, fused_bp2.fused_check_reference(v2c0, layout, rule))
    v2c, bits = fused_bp2.fused_var(c2v, q, layout, rule)
    r_v2c, r_bits = fused_bp2.fused_var_reference(c2v, q, layout, rule)
    assert torch.equal(v2c, r_v2c) and torch.equal(bits, r_bits)
    for b in (bits0, bits):
        flags = fused_bp2.fused_syndrome_bits(b, layout)
        assert torch.equal(flags, fused_bp2.fused_syndrome_bits_reference(b, layout))
    assert (fused_bp2.fused_check.launches, fused_bp2.fused_var.launches,
            fused_bp2.fused_syndrome_bits.launches) == (
        before[0] + 1, before[1] + 2, before[2] + 2)


@pytest.mark.parametrize("decoder", FLOODING)
def test_resident_flooding_kernel_matches_plain_version(cuda, decoder):
    _, args = _flooding_case(decoder, cuda)
    before = resident_flooding_decode.launches
    out = resident_flooding_decode(*args, 6)
    assert resident_flooding_decode.launches == before + 1
    ref = resident_flooding_decode_reference(*args, 6)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert 0 < int(out[2].sum()) < out[2].numel()


def test_flooding_partial_tile_streaming_equals_resident(cuda):
    bg, z = BaseGraph.BG2, 16
    lg = LiftedGraph.from_sparse(bg.h(z), *nr5g_maps(bg, z))
    _, arith = make_arithmetic("Minsumbf16")
    llrs = _llrs(lg.n, 130, 1.3, 11, cuda)
    out = lifted_flooding_decode(lg, arith, llrs, 8)
    stream = lifted_flooding_decode(lg, arith, llrs, 8, resident=False)
    plain = lifted_flooding_decode(lg, arith, llrs.cpu(), 8)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], stream[key]), key
        assert torch.equal(out[key].cpu(), plain[key]), key


@pytest.mark.parametrize("decoder", DECODERS + ["HLNormminsumf32"])
def test_compressed_layered_kernel_matches_plain_version(cuda, decoder):
    lg = lifted_graph_for(DvbCode.R1_4short)
    _, arith = make_arithmetic(decoder)
    args = tile_inputs(lg, arith, _llrs(lg.n, 128, 1.05, 5, cuda))
    before = compressed_layered_decode.launches
    out = compressed_layered_decode(*args, 8)
    assert compressed_layered_decode.launches == before + 1
    ref = compressed_layered_decode_reference(*args, 8)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    for a, b in zip(out, resident_layered_decode(*args, 8)):
        assert torch.equal(a, b)
    assert 0 < int(out[2].sum()) < out[2].numel()


@pytest.mark.parametrize("decoder", FLOODING + ["Normminsumf32"])
def test_compressed_flooding_kernel_matches_plain_version(cuda, decoder):
    _, args = _flooding_case(decoder, cuda)
    before = compressed_flooding_decode.launches
    out = compressed_flooding_decode(*args, 6)
    assert compressed_flooding_decode.launches == before + 1
    ref = compressed_flooding_decode_reference(*args, 6)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    for a, b in zip(out, resident_flooding_decode(*args, 6)):
        assert torch.equal(a, b)
    assert 0 < int(out[2].sum()) < out[2].numel()


def _bg2z16():
    bg, z = BaseGraph.BG2, 16
    return LiftedGraph.from_sparse(bg.h(z), *nr5g_maps(bg, z))


@pytest.mark.parametrize("decoder", COMPRESSED)
@pytest.mark.parametrize("code", ["5G BG2 z=16", "CCSDS C2"])
def test_compressed_kernels_on_small_and_wide_groups(cuda, code, decoder):
    """5G BG2 z=16 (a check group has 16 lanes, far fewer than a block's
    threads; degrees 3 to 10, one bucket) and CCSDS C2 (degree 32, the next
    bucket; Z = 511, more lanes than threads; the layered park in device
    memory), both schedules, against the plain versions."""
    if code == "CCSDS C2":
        lg, batch, sigma = lifted_graph_for(C2Code()), 64, 0.5
    else:
        lg, batch, sigma = _bg2z16(), 128, 1.3
    _, arith = make_arithmetic(decoder)
    x = _llrs(lg.n, batch, sigma, 5, cuda)
    if decoder.startswith("HL"):
        args = tile_inputs(lg, arith, x)
        kernel, plain = compressed_layered_decode, compressed_layered_decode_reference
    else:
        args = flooding_tiles(lg, arith, x)
        kernel, plain = compressed_flooding_decode, compressed_flooding_decode_reference
    before = kernel.launches
    out = kernel(*args, 10)
    assert kernel.launches == before + 1
    for a, b in zip(out, plain(*args, 10)):
        assert torch.equal(a, b)
    assert 0 < int(out[2].sum()) < out[2].numel()


@pytest.mark.parametrize("decoder", [n for n in COMPRESSED if n.endswith("f32")])
def test_compressed_partial_tile_matches_plain(cuda, decoder):
    """A batch of 130 (33 tiles, the last padded) through the decoders'
    glue onto the compressed kernels (the f32 names go there), against the
    CPU."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    llrs = _llrs(lg.n, 130, 1.3, 11, cuda)
    decode = lifted_layered_decode if decoder.startswith("HL") else lifted_flooding_decode
    launches = (compressed_layered_decode.launches, compressed_flooding_decode.launches)
    out = decode(lg, arith, llrs, 10)
    assert (compressed_layered_decode.launches, compressed_flooding_decode.launches) \
        != launches
    ref = decode(lg, arith, llrs.cpu(), 10)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key].cpu(), ref[key]), key


@pytest.mark.parametrize("kernel", ["layered", "flooding"])
def test_compressed_kernels_raise_on_other_tile_widths(cuda, kernel):
    """The kernels give a thread all four frames of a lane: a CUDA tile of
    another width raises before any launch."""
    lg = lifted_graph_for(DvbCode.R1_4short)
    _, arith = make_arithmetic("HLMinsumf32" if kernel == "layered" else "Minsumf32")
    x = _llrs(lg.n, 16, 1.05, 5, cuda)
    tiles = (tile_inputs if kernel == "layered" else flooding_tiles)(lg, arith, x)
    wide = [t.reshape(t.shape[0] // 2, *t.shape[1:3], 8).contiguous() for t in tiles[:2]]
    fn = compressed_layered_decode if kernel == "layered" else compressed_flooding_decode
    before = fn.launches
    with pytest.raises(ValueError, match="tile width 8"):
        fn(*wide, *tiles[2:], 4)
    assert fn.launches == before


def _small_or_wide(code):
    """(graph, batch, sigma) of 5G BG2 z=16 (a check group has 16 lanes, far
    fewer than a block's threads; degrees 3 to 10, one bucket) or CCSDS C2
    (degree 32, the next bucket; Z = 511, more lanes than threads; the
    layered park in device memory)."""
    if code == "CCSDS C2":
        return lifted_graph_for(C2Code()), 64, 0.5
    return _bg2z16(), 128, 1.3


@pytest.mark.parametrize("decoder", DECODERS + FLOODING)
@pytest.mark.parametrize("code", ["5G BG2 z=16", "CCSDS C2"])
def test_message_kernels_on_small_and_wide_groups(cuda, code, decoder):
    """The message kernels (a thread per lane) on both codes for the f32,
    bf16 and normalized bf16 names of both schedules, against the plain
    versions."""
    lg, batch, sigma = _small_or_wide(code)
    _, arith = make_arithmetic(decoder)
    x = _llrs(lg.n, batch, sigma, 5, cuda)
    if decoder.startswith("HL"):
        args = tile_inputs(lg, arith, x)
        kernel, plain = resident_layered_decode, resident_layered_decode_reference
    else:
        args = flooding_tiles(lg, arith, x)
        kernel, plain = resident_flooding_decode, resident_flooding_decode_reference
    before = kernel.launches
    out = kernel(*args, 10)
    assert kernel.launches == before + 1
    for a, b in zip(out, plain(*args, 10)):
        assert torch.equal(a, b)
    assert 0 < int(out[2].sum()) < out[2].numel()


@pytest.mark.parametrize(
    "decoder", ["HLMinsumbf16", "HLNormminsumbf16", "Minsumbf16", "Normminsumbf16"]
)
def test_message_partial_tile_matches_plain(cuda, decoder):
    """A batch of 130 (33 tiles, the last padded) through the decoders'
    glue onto the message kernels (the bf16 names go there), against the
    CPU."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    llrs = _llrs(lg.n, 130, 1.3, 11, cuda)
    layered = decoder.startswith("HL")
    kernel = resident_layered_decode if layered else resident_flooding_decode
    before = kernel.launches
    out = (lifted_layered_decode if layered else lifted_flooding_decode)(lg, arith, llrs, 10)
    assert kernel.launches == before + 1
    ref = (lifted_layered_decode if layered else lifted_flooding_decode)(
        lg, arith, llrs.cpu(), 10
    )
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key].cpu(), ref[key]), key


@pytest.mark.parametrize("kernel", ["layered", "flooding"])
def test_message_kernels_raise_on_other_tile_widths(cuda, kernel):
    """A thread holds all four frames of a lane: a CUDA tile of another
    width raises before any launch."""
    lg = lifted_graph_for(DvbCode.R1_4short)
    _, arith = make_arithmetic("HLMinsumbf16" if kernel == "layered" else "Minsumbf16")
    x = _llrs(lg.n, 16, 1.05, 5, cuda)
    tiles = (tile_inputs if kernel == "layered" else flooding_tiles)(lg, arith, x)
    wide = [t.reshape(t.shape[0] // 2, *t.shape[1:3], 8).contiguous() for t in tiles[:2]]
    fn = resident_layered_decode if kernel == "layered" else resident_flooding_decode
    before = fn.launches
    with pytest.raises(ValueError, match="tile width 8"):
        fn(*wide, *tiles[2:], 4)
    assert fn.launches == before


@pytest.mark.parametrize("decoder", DECODERS)
def test_fused_layered_iteration_matches_plain_version(cuda, decoder):
    """One and two sweeps in place on the same planes."""
    lg = lifted_graph_for(DvbCode.R1_4short)
    _, arith = make_arithmetic(decoder)
    qv0, _, layout, rule = tile_inputs(lg, arith, _llrs(lg.n, 128, 1.05, 5, cuda))
    rcv0 = torch.zeros(
        (qv0.shape[0], layout.E, layout.Z, qv0.shape[3]), dtype=rule.storage_dtype,
        device=cuda,
    )
    kernel, plain = (qv0.clone(), rcv0.clone()), (qv0.clone(), rcv0.clone())
    for _ in range(2):
        before = fused_layered_iteration.launches
        out = fused_layered_iteration(*kernel, layout, rule)
        assert fused_layered_iteration.launches == before + 1
        ref = fused_layered_iteration_reference(*plain, layout, rule)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        kernel, plain = out[:2], ref[:2]


@pytest.mark.parametrize("decoder", ["HLMinsumbf16", "HLMinsumf32"])
def test_c2_layered_decoder_matches_plain_version(cuda, decoder):
    """CCSDS C2 (check degree 32, Z = 511: the park lives in device
    memory) through the Decoder on the card and on the CPU."""
    x = _llrs(8176, 128, 0.48, 5, cuda)
    out = Decoder(C2Code(), decoder, device="cuda").decode_batch(x, max_iterations=10)
    ref = Decoder(C2Code(), decoder, device="cpu").decode_batch(x.cpu(), max_iterations=10)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key].cpu(), ref[key]), key
    assert 0 < int(ref["success"].sum()) < 128


def test_layered_partial_tile_streaming_equals_resident(cuda):
    """Staged compaction on a batch of 130 (33 tiles, the last padded)."""
    bg, z = BaseGraph.BG2, 16
    lg = LiftedGraph.from_sparse(bg.h(z), *nr5g_maps(bg, z))
    _, arith = make_arithmetic("HLMinsumbf16")
    llrs = _llrs(lg.n, 130, 1.3, 11, cuda)
    before = fused_layered_iteration.launches
    stream = lifted_layered_decode(lg, arith, llrs, 10, resident=False)
    assert fused_layered_iteration.launches > before
    out = lifted_layered_decode(lg, arith, llrs, 10)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], stream[key]), key
    assert len(set(out["iterations"].tolist())) >= 3


#: the i8 names of the int8 instances' checks, two a schedule
I8_DECODERS = [
    "HLMinstarapproxi8", "HLAminstari8PartialHardLimit",
    "Minstarapproxi8JonesDeg1Clip", "Aminstari8PartialHardLimitDeg1Clip",
]


def _strong_llrs(n, batch, seed, device):
    """Large-magnitude LLRs (6 to 20) with 1 to 6 % of the signs flipped,
    where the i8 clips and the partial hard limit act."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(6.0, 20.0, (batch, n))
    flip = rng.random((batch, n)) < rng.uniform(0.01, 0.06, (batch, 1))
    return torch.as_tensor(np.where(flip, -mag, mag), dtype=torch.float32, device=device)


def _i8_kernel(decoder):
    if decoder.startswith("HL"):
        return resident_layered_decode_i8, resident_layered_decode_reference, tile_inputs
    return resident_flooding_decode_i8, resident_flooding_decode_reference, flooding_tiles


@pytest.mark.parametrize("decoder", I8_DECODERS)
@pytest.mark.parametrize("code", ["5G BG2 z=16", "CCSDS C2"])
def test_i8_kernels_match_plain_versions(cuda, code, decoder):
    """The int8 instances of the message kernels on 5G BG2 z=16 (64
    large-magnitude frames besides) and CCSDS C2 (degree 32, the i8
    instances' widest bucket; the layered park in device memory) against
    the plain versions; the float wrappers count no launch."""
    lg, batch, sigma = _small_or_wide(code)
    x = _llrs(lg.n, batch, sigma, 5, cuda)
    if code == "5G BG2 z=16":
        x = torch.cat([x, _strong_llrs(lg.n, 64, 6, cuda)])
    kernel, plain, tiles = _i8_kernel(decoder)
    args = tiles(lg, make_arithmetic(decoder)[1], x)
    before = (kernel.launches, resident_layered_decode.launches,
              resident_flooding_decode.launches)
    out = (resident_layered_decode if decoder.startswith("HL") else resident_flooding_decode)(
        *args, 10)
    assert (kernel.launches, resident_layered_decode.launches,
            resident_flooding_decode.launches) == (before[0] + 1, *before[1:])
    for a, b in zip(out, plain(*args, 10)):
        assert torch.equal(a, b)
    assert 0 < int(out[2].sum()) < out[2].numel()


@pytest.mark.parametrize("decoder", ["HLMinstarapproxi8", "Aminstari8JonesPartialHardLimitDeg1Clip"])
def test_i8_partial_tile_matches_plain(cuda, decoder):
    """A batch of 130 through the decoders' glue onto the int8 instances,
    against the CPU; and no iteration at all keeps the raw-channel bits."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    kernel = _i8_kernel(decoder)[0]
    decode = lifted_layered_decode if decoder.startswith("HL") else lifted_flooding_decode
    llrs = _llrs(lg.n, 130, 1.3, 11, cuda)
    tiny = torch.rand((16, lg.n), generator=torch.Generator().manual_seed(3)) * 0.06
    tiny[:, ::7] *= -1
    for x, iters in ((llrs, 10), (tiny.to(cuda), 0)):
        before = kernel.launches
        out = decode(lg, arith, x, iters)
        assert kernel.launches == before + 1
        ref = decode(lg, arith, x.cpu(), iters)
        for key in ("codeword", "iterations", "success"):
            assert torch.equal(out[key].cpu(), ref[key]), key
    assert torch.equal(out["codeword"].cpu(), (tiny <= 0).to(torch.uint8))


@pytest.mark.parametrize("decoder", ["HLMinstarapproxi8", "Aminstari8"])
def test_i8_kernels_refuse_checks_above_their_cap(cuda, decoder):
    """The int8 instances take check degree 32 at most: a layout whose
    checks are wider is refused before any launch, naming the cap."""
    lg = _bg2z16()
    kernel, _, tiles = _i8_kernel(decoder)
    q, bits0, layout, rule = tiles(lg, make_arithmetic(decoder)[1], _llrs(lg.n, 8, 1.3, 5, cuda))
    m = layout.chk_meta[0]
    wide = dataclasses.replace(layout, chk_meta=(dataclasses.replace(m, d=33),)
                               + layout.chk_meta[1:])
    before = kernel.launches
    with pytest.raises(ValueError, match="above 32"):
        kernel(q, bits0, wide, rule, 4)
    assert kernel.launches == before


#: one name a float rule and precision, the schedules alternating
FLOAT_DECODERS = [
    "Phif32", "HLPhif64", "HLTanhf32", "Tanhf64",
    "Minstarapproxf32", "HLMinstarapproxf64", "HLAminstarf32", "Aminstarf64",
]


def _float_kernel(decoder):
    if decoder.startswith("HL"):
        return resident_layered_decode_float, resident_layered_decode_reference, tile_inputs
    return resident_flooding_decode_float, resident_flooding_decode_reference, flooding_tiles


@pytest.mark.parametrize("decoder", FLOAT_DECODERS)
@pytest.mark.parametrize("code", ["5G BG2 z=16", "CCSDS C2"])
def test_float_kernels_match_plain_versions(cuda, code, decoder):
    """The float-rule instances of the message kernels on 5G BG2 z=16 (64
    large-magnitude frames besides) and CCSDS C2 (degree 32; the layered
    park in device memory) against the plain versions on the card, bit for
    bit; the min-sum wrappers count no launch."""
    lg, batch, sigma = _small_or_wide(code)
    x = _llrs(lg.n, batch, sigma, 5, cuda)
    if code == "5G BG2 z=16":
        x = torch.cat([x, _strong_llrs(lg.n, 64, 6, cuda)])
    kernel, plain, tiles = _float_kernel(decoder)
    args = tiles(lg, make_arithmetic(decoder)[1], x)
    assert args[0].dtype == (torch.float64 if decoder.endswith("f64") else torch.float32)
    before = (kernel.launches, resident_layered_decode.launches,
              resident_flooding_decode.launches)
    out = (resident_layered_decode if decoder.startswith("HL") else resident_flooding_decode)(
        *args, 10)
    assert (kernel.launches, resident_layered_decode.launches,
            resident_flooding_decode.launches) == (before[0] + 1, *before[1:])
    for a, b in zip(out, plain(*args, 10)):
        assert torch.equal(a, b)
    assert int(out[2].sum()) > 0


@pytest.mark.parametrize("decoder", ["HLPhif32", "Aminstarf64"])
def test_float_partial_tile_matches_plain(cuda, decoder):
    """A batch of 130 through the decoders' glue onto the float instances,
    against the CPU."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    kernel = _float_kernel(decoder)[0]
    decode = lifted_layered_decode if decoder.startswith("HL") else lifted_flooding_decode
    x = _llrs(lg.n, 130, 1.3, 11, cuda)
    before = kernel.launches
    out = decode(lg, arith, x, 10)
    assert kernel.launches == before + 1
    ref = decode(lg, arith, x.cpu(), 10)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key].cpu(), ref[key]), key


@pytest.mark.parametrize("decoder", ["HLMinstarapproxf32", "Minstarapproxf64"])
def test_minstarapprox_kernels_refuse_checks_above_32(cuda, decoder):
    """MinstarApprox's float instances take check degree 32 at most: a
    layout whose checks are wider is refused before any launch."""
    lg = _bg2z16()
    kernel, _, tiles = _float_kernel(decoder)
    q, bits0, layout, rule = tiles(lg, make_arithmetic(decoder)[1], _llrs(lg.n, 8, 1.3, 5, cuda))
    m = layout.chk_meta[0]
    wide = dataclasses.replace(layout, chk_meta=(dataclasses.replace(m, d=33),)
                               + layout.chk_meta[1:])
    before = kernel.launches
    with pytest.raises(ValueError, match="above 32"):
        kernel(q, bits0, wide, rule, 4)
    assert kernel.launches == before


#: the i8 and float names of the streaming instances' checks: both i8
#: families a schedule (the flooding ones with every clip), one float name
#: a rule and precision
STREAMING_DECODERS = [
    "Minstarapproxi8JonesPartialHardLimitDeg1Clip", "Aminstari8JonesDeg1Clip",
    "HLMinstarapproxi8PartialHardLimit", "HLAminstari8",
] + FLOAT_DECODERS


def _streaming_case(code, decoder, device):
    """(tiles, layout, rule) of a streaming check: 5G BG2 z=16 with 64
    large-magnitude frames besides, or CCSDS C2 (degree 32; the layered
    park in device memory)."""
    lg, batch, sigma = _small_or_wide(code)
    x = _llrs(lg.n, batch, sigma, 5, device)
    if code == "5G BG2 z=16":
        x = torch.cat([x, _strong_llrs(lg.n, 64, 6, device)])
    tiles = tile_inputs if decoder.startswith("HL") else flooding_tiles
    return tiles(lg, make_arithmetic(decoder)[1], x)


def _family(rule):
    return "i8" if fused_bp2.is_i8(rule) else "float"


@pytest.mark.parametrize("decoder", [n for n in STREAMING_DECODERS if not n.startswith("HL")])
@pytest.mark.parametrize("code", ["5G BG2 z=16", "CCSDS C2"])
def test_streaming_phase_instances_match_plain_versions(cuda, code, decoder):
    """The i8 and float instances of the check and variable phase kernels
    (the initialisation, a check phase, an update, a second check phase)
    against the plain versions, bit for bit, each launch counted on its
    family's wrapper and none on the min-sum ones."""
    q, _, layout, rule = _streaming_case(code, decoder, cuda)
    family = _family(rule)
    check = getattr(fused_bp2, f"fused_check_{family}")
    var = getattr(fused_bp2, f"fused_var_{family}")
    before = (check.launches, var.launches, fused_bp2.fused_check.launches,
              fused_bp2.fused_var.launches)
    v2c, bits = fused_bp2.fused_var(None, q, layout, rule)
    ref = fused_bp2.fused_var_reference(None, q, layout, rule)
    assert torch.equal(v2c, ref[0]) and torch.equal(bits, ref[1])
    for _ in range(2):
        c2v = fused_bp2.fused_check(v2c, layout, rule)
        assert torch.equal(c2v, fused_bp2.fused_check_reference(v2c, layout, rule))
        v2c, bits = fused_bp2.fused_var(c2v, q, layout, rule)
        ref = fused_bp2.fused_var_reference(c2v, q, layout, rule)
        assert torch.equal(v2c, ref[0]) and torch.equal(bits, ref[1])
    assert (check.launches, var.launches, fused_bp2.fused_check.launches,
            fused_bp2.fused_var.launches) == (before[0] + 2, before[1] + 3, *before[2:])
    assert 0 < int(bits.sum()) < bits.numel()


@pytest.mark.parametrize("decoder", [n for n in STREAMING_DECODERS if n.startswith("HL")])
@pytest.mark.parametrize("code", ["5G BG2 z=16", "CCSDS C2"])
def test_streaming_sweep_instances_match_plain_versions(cuda, code, decoder):
    """The i8 and float instances of the streaming sweep, one and two
    sweeps in place on the same planes (int16 Qv for the i8 names, f64 for
    the f64 names), against the plain version, bit for bit."""
    qv0, _, layout, rule = _streaming_case(code, decoder, cuda)
    sweep = getattr(fused_layered_ops, f"fused_layered_iteration_{_family(rule)}")
    rcv0 = torch.zeros((qv0.shape[0], layout.E, layout.Z, 4), dtype=rule.storage_dtype,
                       device=cuda)
    kernel, plain = (qv0.clone(), rcv0.clone()), (qv0.clone(), rcv0.clone())
    for _ in range(2):
        before = (sweep.launches, fused_layered_iteration.launches)
        out = fused_layered_iteration(*kernel, layout, rule)
        assert (sweep.launches, fused_layered_iteration.launches) == (
            before[0] + 1, before[1])
        ref = fused_layered_iteration_reference(*plain, layout, rule)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        kernel, plain = out[:2], ref[:2]


@pytest.mark.parametrize("decoder", STREAMING_DECODERS)
def test_streaming_decode_equals_resident(cuda, decoder):
    """``resident=False`` of an i8 or float name on a batch of 130 (staged
    compaction; int8, int16 and f64 state) equals the resident decode on
    the card and the plain versions on the CPU."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    decode = lifted_layered_decode if decoder.startswith("HL") else lifted_flooding_decode
    x = _llrs(lg.n, 130, 1.3, 11, cuda)
    stream = decode(lg, arith, x, 10, resident=False)
    out = decode(lg, arith, x, 10)
    ref = decode(lg, arith, x.cpu(), 10, resident=False)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], stream[key]), key
        assert torch.equal(stream[key].cpu(), ref[key]), key
    assert len(set(out["iterations"].tolist())) >= 3


@pytest.mark.parametrize("decoder", ["Minsumbf16", "Aminstari8", "Phif64"])
def test_phase_kernels_raise_on_other_tile_widths(cuda, decoder):
    """The phase kernels take a lane's four frames: tiles of 8 raise
    before any launch, on every family."""
    lg = _bg2z16()
    q, _, layout, rule = flooding_tiles(lg, make_arithmetic(decoder)[1],
                                        _llrs(lg.n, 16, 1.3, 5, cuda))
    wide = q.reshape(q.shape[0] // 2, *q.shape[1:3], 8).contiguous()
    with pytest.raises(ValueError, match="tile width 8"):
        fused_bp2.fused_var(None, wide, layout, rule)


#: the f64 float names, whose flooding kernels give a thread one (lane,
#: frame) unit at their own block size (TPU #4/#5 resident, #7 and #8 the
#: phases), and a code of each check-degree bucket the test codes reach
F64_FLOODING = ["Phif64", "Tanhf64", "Minstarapproxf64", "Aminstarf64"]
F64_BUCKETS = {"DVB-S2 R1_4short": 8, "5G BG2 z=16": 16, "CCSDS C2": 32}


def _f64_case(code, decoder, device):
    """Flooding tiles of an f64 name: R1_4short at B = 128 (degree 4 and 5,
    bucket 8, the flagship's), 5G BG2 z=16 with 64 large-magnitude frames
    (bucket 16) or CCSDS C2 (bucket 32)."""
    if code == "DVB-S2 R1_4short":
        lg, batch, sigma = lifted_graph_for(DvbCode.R1_4short), 128, 0.9
    else:
        lg, batch, sigma = _small_or_wide(code)
    x = _llrs(lg.n, batch, sigma, 5, device)
    if code == "5G BG2 z=16":
        x = torch.cat([x, _strong_llrs(lg.n, 64, 6, device)])
    return flooding_tiles(lg, make_arithmetic(decoder)[1], x)


@pytest.mark.parametrize("decoder", F64_FLOODING)
@pytest.mark.parametrize("code", list(F64_BUCKETS))
def test_f64_flooding_units_match_plain_versions(cuda, code, decoder):
    """The f64 instances of the resident flooding kernel and of the check
    and variable phases, one (lane, frame) a thread, against the plain
    versions on the card, bit for bit, at each degree bucket; launches
    counted on the float wrappers."""
    q, bits0, layout, rule = _f64_case(code, decoder, cuda)
    assert q.dtype == torch.float64
    assert min(b for b in (8, 16, 32, 64) if b >= layout.max_chk_degree) == F64_BUCKETS[code]
    before = resident_flooding_decode_float.launches
    out = resident_flooding_decode(q, bits0, layout, rule, 10)
    assert resident_flooding_decode_float.launches == before + 1
    for a, b in zip(out, resident_flooding_decode_reference(q, bits0, layout, rule, 10)):
        assert torch.equal(a, b)
    assert int(out[2].sum()) > 0
    before = (fused_bp2.fused_check_float.launches, fused_bp2.fused_var_float.launches)
    v2c = fused_bp2.fused_var(None, q, layout, rule)[0]
    for _ in range(2):
        c2v = fused_bp2.fused_check(v2c, layout, rule)
        assert torch.equal(c2v, fused_bp2.fused_check_reference(v2c, layout, rule))
        v2c, bits = fused_bp2.fused_var(c2v, q, layout, rule)
        ref = fused_bp2.fused_var_reference(c2v, q, layout, rule)
        assert torch.equal(v2c, ref[0]) and torch.equal(bits, ref[1])
    assert (fused_bp2.fused_check_float.launches, fused_bp2.fused_var_float.launches) == (
        before[0] + 2, before[1] + 3)


@pytest.mark.parametrize("decoder", F64_FLOODING)
def test_f64_flooding_partial_tile(cuda, decoder):
    """A batch of 130 (a partial tile) through the flooding decoder's glue
    onto the f64 units, resident and streaming, against the CPU."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    x = _llrs(lg.n, 130, 1.3, 11, cuda)
    ref = lifted_flooding_decode(lg, arith, x.cpu(), 10)
    for resident in (True, False):
        out = lifted_flooding_decode(lg, arith, x, 10, resident=resident)
        for key in ("codeword", "iterations", "success"):
            assert torch.equal(out[key].cpu(), ref[key]), (resident, key)


#: the f32 layered float names, whose resident layered kernel (TPU #1) gives
#: a check lane's thread a frame pair of a lane and whose streaming sweep
#: (#3) a lane's four frames, on a code of each check-degree bucket
F32_LAYERED = ["HLPhif32", "HLTanhf32", "HLMinstarapproxf32", "HLAminstarf32"]


def _f32_layered_case(code, decoder, device):
    """Layered tiles of an f32 name on the codes of ``_f64_case``: R1_4short
    at B = 128 (bucket 8, the flagship's), 5G BG2 z=16 with 64
    large-magnitude frames (bucket 16) or CCSDS C2 (bucket 32, every group
    parked, the park in device memory)."""
    if code == "DVB-S2 R1_4short":
        lg, batch, sigma = lifted_graph_for(DvbCode.R1_4short), 128, 0.9
    else:
        lg, batch, sigma = _small_or_wide(code)
    x = _llrs(lg.n, batch, sigma, 5, device)
    if code == "5G BG2 z=16":
        x = torch.cat([x, _strong_llrs(lg.n, 64, 6, device)])
    return tile_inputs(lg, make_arithmetic(decoder)[1], x)


@pytest.mark.parametrize("decoder", F32_LAYERED)
@pytest.mark.parametrize("code", list(F64_BUCKETS))
def test_f32_layered_units_match_plain_versions(cuda, code, decoder):
    """The f32 instances of the resident layered kernel (a frame pair of a
    lane a thread in the check lanes) and of the streaming sweep against
    the plain versions on the card, bit for bit, at each degree bucket: a
    decode, and two sweeps in place; launches counted on the float
    wrappers."""
    qv0, bits0, layout, rule = _f32_layered_case(code, decoder, cuda)
    assert qv0.dtype == torch.float32
    assert min(b for b in (8, 16, 32, 64) if b >= layout.max_chk_degree) == F64_BUCKETS[code]
    before = resident_layered_decode_float.launches
    out = resident_layered_decode(qv0, bits0, layout, rule, 10)
    assert resident_layered_decode_float.launches == before + 1
    for a, b in zip(out, resident_layered_decode_reference(qv0, bits0, layout, rule, 10)):
        assert torch.equal(a, b)
    assert int(out[2].sum()) > 0
    sweep = fused_layered_ops.fused_layered_iteration_float
    rcv0 = torch.zeros((qv0.shape[0], layout.E, layout.Z, 4), dtype=torch.float32,
                       device=cuda)
    kernel, plain = (qv0.clone(), rcv0.clone()), (qv0.clone(), rcv0.clone())
    before = sweep.launches
    for _ in range(2):
        out = fused_layered_iteration(*kernel, layout, rule)
        ref = fused_layered_iteration_reference(*plain, layout, rule)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        kernel, plain = out[:2], ref[:2]
    assert sweep.launches == before + 2


@pytest.mark.parametrize("decoder", F32_LAYERED)
def test_f32_layered_partial_tile(cuda, decoder):
    """A batch of 130 (a partial tile) through the layered decoder's glue
    onto the f32 instances, resident (frame pairs) and streaming, against
    the CPU."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    x = _llrs(lg.n, 130, 1.3, 11, cuda)
    ref = lifted_layered_decode(lg, arith, x.cpu(), 10)
    for resident in (True, False):
        out = lifted_layered_decode(lg, arith, x, 10, resident=resident)
        for key in ("codeword", "iterations", "success"):
            assert torch.equal(out[key].cpu(), ref[key]), (resident, key)


#: the f64 layered float names, whose resident layered kernel (TPU #1) and
#: streaming sweep (#3) give a check lane's thread one frame of a lane at
#: their own blocks; the check-degree buckets of the f64 flooding cases and
#: 64, which a quasi-cyclic code of degree 40 reaches (MinstarApprox takes 32
#: at most)
F64_LAYERED = ["HLPhif64", "HLTanhf64", "HLMinstarapproxf64", "HLAminstarf64"]
F64_LAYERED_BUCKETS = {**F64_BUCKETS, "QC 3x40 z=16": 64}


def _qc_degree40():
    """A quasi-cyclic code of 3 x 40 circulants of Z = 16, each a seeded
    shift (every check of degree 40: bucket 64, which no standards code
    reaches), and its (batch, sigma): 88 of 128 frames converge within 10
    iterations."""
    rng = np.random.default_rng(64)
    z, rows, cols = 16, 3, 40
    h = SparseMatrix(rows * z, cols * z)
    for r in range(rows):
        for c in range(cols):
            s = int(rng.integers(z))
            for i in range(z):
                h.insert(r * z + i, c * z + (i + s) % z)
    blocks = lambda j: (j // z, j % z)  # noqa: E731
    return LiftedGraph.from_sparse(h, blocks, blocks, z, cols, rows), 128, 0.45


def _f64_layered_case(code, decoder, device):
    """Layered tiles of an f64 name on the codes of ``_f32_layered_case``,
    or on the degree-40 quasi-cyclic code (bucket 64)."""
    if code != "QC 3x40 z=16":
        return _f32_layered_case(code, decoder, device)
    lg, batch, sigma = _qc_degree40()
    return tile_inputs(lg, make_arithmetic(decoder)[1], _llrs(lg.n, batch, sigma, 5, device))


@pytest.mark.parametrize("decoder,code", [
    (decoder, code) for code in F64_LAYERED_BUCKETS for decoder in F64_LAYERED
    if not (decoder == "HLMinstarapproxf64" and F64_LAYERED_BUCKETS[code] > 32)
])
def test_f64_layered_units_match_plain_versions(cuda, code, decoder):
    """The f64 instances of the resident layered kernel and of the streaming
    sweep (one frame of a lane a thread in the check lanes) against the
    plain versions on the card, bit for bit, at each degree bucket: a
    decode, and two sweeps in place; launches counted on the float
    wrappers."""
    qv0, bits0, layout, rule = _f64_layered_case(code, decoder, cuda)
    assert qv0.dtype == torch.float64
    bucket = min(b for b in (8, 16, 32, 64) if b >= layout.max_chk_degree)
    assert bucket == F64_LAYERED_BUCKETS[code]
    before = resident_layered_decode_float.launches
    out = resident_layered_decode(qv0, bits0, layout, rule, 10)
    assert resident_layered_decode_float.launches == before + 1
    for a, b in zip(out, resident_layered_decode_reference(qv0, bits0, layout, rule, 10)):
        assert torch.equal(a, b)
    assert int(out[2].sum()) > 0
    sweep = fused_layered_ops.fused_layered_iteration_float
    rcv0 = torch.zeros((qv0.shape[0], layout.E, layout.Z, 4), dtype=torch.float64,
                       device=cuda)
    kernel, plain = (qv0.clone(), rcv0.clone()), (qv0.clone(), rcv0.clone())
    before = sweep.launches
    for _ in range(2):
        out = fused_layered_iteration(*kernel, layout, rule)
        ref = fused_layered_iteration_reference(*plain, layout, rule)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        kernel, plain = out[:2], ref[:2]
    assert sweep.launches == before + 2


@pytest.mark.parametrize("decoder", F64_LAYERED)
def test_f64_layered_partial_tile(cuda, decoder):
    """A batch of 130 (a partial tile) through the layered decoder's glue
    onto the f64 instances, resident and streaming, against the CPU."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    x = _llrs(lg.n, 130, 1.3, 11, cuda)
    ref = lifted_layered_decode(lg, arith, x.cpu(), 10)
    for resident in (True, False):
        out = lifted_layered_decode(lg, arith, x, 10, resident=resident)
        for key in ("codeword", "iterations", "success"):
            assert torch.equal(out[key].cpu(), ref[key]), (resident, key)


#: the f32 flooding float names, whose resident flooding kernel (TPU #4/#5)
#: and check and variable phases (#7, #8) give a thread a unit of their own
#: (FloatRule's FloodUnits) at ``fused_bp2.F32_UNIT_THREADS``
F32_FLOODING = ["Phif32", "Tanhf32", "Minstarapproxf32", "Aminstarf32"]


def _f32_flooding_case(code, decoder, device):
    """Flooding tiles of an f32 name on the codes of ``_f64_case``, or on
    the degree-40 quasi-cyclic code (bucket 64)."""
    if code != "QC 3x40 z=16":
        return _f64_case(code, decoder, device)
    lg, batch, sigma = _qc_degree40()
    return flooding_tiles(lg, make_arithmetic(decoder)[1], _llrs(lg.n, batch, sigma, 5, device))


@pytest.mark.parametrize("decoder,code", [
    (decoder, code) for code in F64_LAYERED_BUCKETS for decoder in F32_FLOODING
    if not (decoder == "Minstarapproxf32" and F64_LAYERED_BUCKETS[code] > 32)
])
def test_f32_flooding_units_match_plain_versions(cuda, code, decoder):
    """The f32 instances of the resident flooding kernel and of the check
    and variable phases, a unit of FloodUnits a thread, against the plain
    versions on the card, bit for bit, at each degree bucket: a decode, the
    initialisation and two iterations of phases; launches counted on the
    float wrappers."""
    q, bits0, layout, rule = _f32_flooding_case(code, decoder, cuda)
    assert q.dtype == torch.float32
    bucket = min(b for b in (8, 16, 32, 64) if b >= layout.max_chk_degree)
    assert bucket == F64_LAYERED_BUCKETS[code]
    before = resident_flooding_decode_float.launches
    out = resident_flooding_decode(q, bits0, layout, rule, 10)
    assert resident_flooding_decode_float.launches == before + 1
    for a, b in zip(out, resident_flooding_decode_reference(q, bits0, layout, rule, 10)):
        assert torch.equal(a, b)
    assert int(out[2].sum()) > 0
    before = (fused_bp2.fused_check_float.launches, fused_bp2.fused_var_float.launches)
    v2c, bits = fused_bp2.fused_var(None, q, layout, rule)
    ref = fused_bp2.fused_var_reference(None, q, layout, rule)
    assert torch.equal(v2c, ref[0]) and torch.equal(bits, ref[1])
    for _ in range(2):
        c2v = fused_bp2.fused_check(v2c, layout, rule)
        assert torch.equal(c2v, fused_bp2.fused_check_reference(v2c, layout, rule))
        v2c, bits = fused_bp2.fused_var(c2v, q, layout, rule)
        ref = fused_bp2.fused_var_reference(c2v, q, layout, rule)
        assert torch.equal(v2c, ref[0]) and torch.equal(bits, ref[1])
    assert (fused_bp2.fused_check_float.launches, fused_bp2.fused_var_float.launches) == (
        before[0] + 2, before[1] + 3)


@pytest.mark.parametrize("decoder", F32_FLOODING)
def test_f32_flooding_partial_tile(cuda, decoder):
    """A batch of 130 (a partial tile) through the flooding decoder's glue
    onto the f32 units, resident and streaming, against the CPU."""
    lg = _bg2z16()
    _, arith = make_arithmetic(decoder)
    x = _llrs(lg.n, 130, 1.3, 11, cuda)
    ref = lifted_flooding_decode(lg, arith, x.cpu(), 10)
    for resident in (True, False):
        out = lifted_flooding_decode(lg, arith, x, 10, resident=resident)
        for key in ("codeword", "iterations", "success"):
            assert torch.equal(out[key].cpu(), ref[key]), (resident, key)


def test_i8_steps_exhaustive(cuda):
    """The i8 rules' word steps on the card (``csrc/i8.cuh`` through
    ``i8_steps``: the correction table, both families' folds, the partial
    hard limit) on every byte pair in [0, 127]^2, four frames a word, each
    frame's byte through its own permutation of the pairs, against the
    plain rules' value of each byte."""
    a = torch.arange(128, dtype=torch.int32).repeat_interleave(128)
    b = torch.arange(128, dtype=torch.int32).repeat(128)
    g = torch.Generator().manual_seed(0)
    perms = [torch.randperm(a.numel(), generator=g) for _ in range(fused_bp2.BT)]
    wa = sum(a[p] << 8 * f for f, p in enumerate(perms))
    wb = sum(b[p] << 8 * f for f, p in enumerate(perms))
    before = fused_bp2.i8_steps.launches
    out = fused_bp2.i8_steps(wa.to(cuda), wb.to(cuda))
    assert fused_bp2.i8_steps.launches == before + 1
    assert torch.equal(out.cpu(), fused_bp2.i8_steps_reference(wa, wb))


#: every i8 name: both families, the eight variants of flooding, the
#: partial hard limit of layered (the clips of the variable side are
#: flooding's alone)
I8_VARIANTS = [
    prefix + "Jones" * j + "PartialHardLimit" * h + "Deg1Clip" * c
    for prefix in ("Minstarapproxi8", "Aminstari8")
    for j in (0, 1) for h in (0, 1) for c in (0, 1)
] + [f"HL{f}i8{h}" for f in ("Minstarapprox", "Aminstar") for h in ("", "PartialHardLimit")]


@pytest.mark.parametrize("decoder", I8_VARIANTS)
@pytest.mark.parametrize("code", list(F64_BUCKETS))
def test_i8_variants_match_plain_versions(cuda, code, decoder):
    """Every i8 name on the int8 instances of the resident message kernels
    at each check-degree bucket (R1_4short at B = 128, bucket 8, the
    flagship's; 5G BG2 z=16 with 64 large-magnitude frames, bucket 16;
    CCSDS C2, bucket 32) against the plain versions, bit for bit."""
    if code == "DVB-S2 R1_4short":
        lg, batch, sigma = lifted_graph_for(DvbCode.R1_4short), 128, 0.9
    else:
        lg, batch, sigma = _small_or_wide(code)
    x = _llrs(lg.n, batch, sigma, 5, cuda)
    if code == "5G BG2 z=16":
        x = torch.cat([x, _strong_llrs(lg.n, 64, 6, cuda)])
    kernel, plain, tiles = _i8_kernel(decoder)
    args = tiles(lg, make_arithmetic(decoder)[1], x)
    assert min(b for b in (8, 16, 32) if b >= args[2].max_chk_degree) == F64_BUCKETS[code]
    before = kernel.launches
    out = kernel(*args, 10)
    assert kernel.launches == before + 1
    for a, b in zip(out, plain(*args, 10)):
        assert torch.equal(a, b)
    assert int(out[2].sum()) > 0


def _i8_streaming_tiles(code, decoder, device, batch=128):
    """(tiles, layout, rule) of an i8 name's streaming instance at a
    check-degree bucket: R1_4short (bucket 8, missing lanes) at ``batch``
    frames, or ``_streaming_case``'s 5G BG2 z=16 (bucket 16) and CCSDS C2
    (bucket 32)."""
    if code != "DVB-S2 R1_4short":
        return _streaming_case(code, decoder, device)
    lg = lifted_graph_for(DvbCode.R1_4short)
    tiles = tile_inputs if decoder.startswith("HL") else flooding_tiles
    return tiles(lg, make_arithmetic(decoder)[1], _llrs(lg.n, batch, 0.9, 5, device))


def _hold_i8_streaming(tiles, layered):
    """The sweep (two in place in a row) or the check phase (two, each on
    the v2c of an update) of an i8 streaming instance against the plain
    version, bit for bit, each launch counted on its wrapper."""
    x0, _, layout, rule = tiles
    if layered:
        rcv0 = torch.zeros((x0.shape[0], layout.E, layout.Z, 4), dtype=torch.int8,
                           device=x0.device)
        kernel, plain = (x0.clone(), rcv0.clone()), (x0.clone(), rcv0.clone())
        for _ in range(2):
            before = fused_layered_ops.fused_layered_iteration_i8.launches
            out = fused_layered_ops.fused_layered_iteration_i8(*kernel, layout, rule)
            assert fused_layered_ops.fused_layered_iteration_i8.launches == before + 1
            ref = fused_layered_iteration_reference(*plain, layout, rule)
            for a, b in zip(out, ref):
                assert torch.equal(a, b)
            kernel, plain = out[:2], ref[:2]
        return
    v2c = fused_bp2.fused_var(None, x0, layout, rule)[0]
    for _ in range(2):
        before = fused_bp2.fused_check_i8.launches
        c2v = fused_bp2.fused_check_i8(v2c, layout, rule)
        assert fused_bp2.fused_check_i8.launches == before + 1
        assert torch.equal(c2v, fused_bp2.fused_check_reference(v2c, layout, rule))
        v2c = fused_bp2.fused_var(c2v, x0, layout, rule)[0]


@pytest.mark.parametrize("decoder", I8_VARIANTS)
@pytest.mark.parametrize("code", list(F64_BUCKETS))
def test_i8_streaming_forms_match_plain_versions(cuda, code, decoder):
    """The int8 instances of the streaming sweep (TPU #3, the layered names)
    and check phase (#7, the flooding names) of ``csrc/i8_streaming.cuh``
    (their own blocks, MinstarApprox's fold on the FMA pipe) against the
    plain versions, bit for bit: every i8 name, both families, at each
    check-degree bucket (8 with missing lanes, 16 with large magnitudes,
    32 with the sweep's park in device memory); two sweeps in place in a
    row, two check phases each after an update."""
    tiles = _i8_streaming_tiles(code, decoder, cuda)
    assert min(b for b in (8, 16, 32) if b >= tiles[2].max_chk_degree) == F64_BUCKETS[code]
    if code == "DVB-S2 R1_4short":
        assert int((tiles[2].syn_mask >= 0).sum()) > 0
    _hold_i8_streaming(tiles, decoder.startswith("HL"))


@pytest.mark.parametrize("tiles", [1, 133])
@pytest.mark.parametrize("decoder", ["HLMinstarapproxi8", "HLAminstari8PartialHardLimit",
                                     "Minstarapproxi8JonesPartialHardLimitDeg1Clip",
                                     "Aminstari8Deg1Clip"])
def test_i8_streaming_forms_on_odd_tile_counts(cuda, decoder, tiles):
    """The i8 streaming sweep and check phase on one tile (B = 4) and on
    133 tiles, a count no grid of the card's 132 SMs divides, against the
    plain versions, bit for bit."""
    found = _i8_streaming_tiles("DVB-S2 R1_4short", decoder, cuda, batch=4 * tiles)
    assert found[0].shape[0] == tiles
    _hold_i8_streaming(found, decoder.startswith("HL"))


#: the syndrome kernel's cases: one code of each check-degree bucket the
#: test codes reach (R1_4short 8, with missing lanes; 5G BG2 z=16 16; CCSDS
#: C2 32, Z = 511) and a partial tile (5G BG2 z=16 at B = 130: 33 tiles, the
#: last padded with frames that pass at once)
SYNDROME_CASES = list(F64_BUCKETS) + ["partial tile"]


def _syndrome_bits(code, device):
    """(layout, the raw bits, the posterior bits after two plain flooding
    iterations, and those with frame 0 of every other tile set to the
    all-zero codeword, which passes) of a syndrome case."""
    if code == "DVB-S2 R1_4short":
        lg, batch, sigma = lifted_graph_for(DvbCode.R1_4short), 128, 0.85
    else:
        lg, batch, sigma = _small_or_wide("CCSDS C2" if code == "CCSDS C2" else "5G BG2 z=16")
        batch = 130 if code == "partial tile" else batch
    q, bits0, layout, rule = flooding_tiles(lg, make_arithmetic("Minsumbf16")[1],
                                            _llrs(lg.n, batch, sigma, 5, device))
    v2c = fused_bp2.fused_var_reference(None, q, layout, rule)[0]
    for _ in range(2):
        c2v = fused_bp2.fused_check_reference(v2c, layout, rule)
        v2c, post = fused_bp2.fused_var_reference(c2v, q, layout, rule)
    mixed = post.clone()
    mixed[::2, :, :, 0] = 0
    return layout, (bits0, post, mixed)


def _freeze_state(nbt, device, seed):
    """A loop's state before a freeze: a third of the frames converged,
    their iterations and frozen bits made up."""
    g = torch.Generator().manual_seed(seed)
    frames = nbt * fused_bp2.BT
    conv = torch.rand(frames, generator=g) < 0.3
    iters = torch.randint(0, 5, (frames,), generator=g, dtype=torch.int32)
    return conv.to(device), iters.to(device)


@pytest.mark.parametrize("code", SYNDROME_CASES)
def test_syndrome_kernel_matches_plain_version(cuda, code):
    """The flags of the raw, posterior and mixed bits, bit for bit."""
    layout, cases = _syndrome_bits(code, cuda)
    before = fused_bp2.fused_syndrome_bits.launches
    for bits in cases:
        flags = fused_bp2.fused_syndrome_bits(bits, layout)
        assert torch.equal(flags, fused_bp2.fused_syndrome_bits_reference(bits, layout))
    assert fused_bp2.fused_syndrome_bits.launches == before + len(cases)
    assert 0 < int(flags.sum()) < flags.numel()


@pytest.mark.parametrize("code", SYNDROME_CASES)
def test_syndrome_freeze_matches_plain_version(cuda, code):
    """Three freezes in a row on one state (the mixed bits, where frames of
    unconverged tiles pass; the posterior bits; all-zero bits, where every
    frame passes, whole tiles at once), each against the plain version on
    a copy: iterations, flags, frozen bits and the count, bit for bit."""
    layout, (_, post, mixed) = _syndrome_bits(code, cuda)
    nbt = post.shape[0]
    conv, iters = _freeze_state(nbt, cuda, seed=1)
    frozen = torch.randint(-128, 128, post.shape, dtype=torch.int8, device=cuda)
    counter = torch.full((1,), -7, dtype=torch.int32, device=cuda)
    mine = (frozen, conv, iters, counter)
    plain = tuple(x.clone() for x in mine)
    before = fused_bp2.fused_syndrome_freeze.launches
    for it, bits in enumerate((mixed, post, torch.zeros_like(post)), start=5):
        newly = int((~mine[1]).sum())
        fused_bp2.fused_syndrome_freeze(bits, *mine[:3], it, mine[3], layout)
        fused_bp2.fused_syndrome_freeze_reference(bits, *plain[:3], it, plain[3], layout)
        for a, b in zip(mine, plain):
            assert torch.equal(a, b), it
        newly -= int((~mine[1]).sum())
        assert int(mine[3]) == int((~mine[1]).sum())
        assert newly > 0 or bits is post
    assert fused_bp2.fused_syndrome_freeze.launches == before + 3
    assert int(counter) == 0


def test_syndrome_freeze_unaligned_tiles(cuda):
    """frozen 4 bytes past a 16-byte boundary: the freeze copies a word a
    lane, equal to the plain version."""
    layout, (_, post, mixed) = _syndrome_bits("5G BG2 z=16", cuda)
    buf = torch.zeros(post.numel() + 4, dtype=torch.int8, device=cuda)
    frozen = buf[4:].view(post.shape)
    assert frozen.data_ptr() % 16 == 4
    conv, iters = _freeze_state(post.shape[0], cuda, seed=2)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    plain = (frozen.clone(), conv.clone(), iters.clone(), counter.clone())
    fused_bp2.fused_syndrome_freeze(mixed, frozen, conv, iters, 3, counter, layout)
    fused_bp2.fused_syndrome_freeze_reference(mixed, *plain[:3], 3, plain[3], layout)
    for a, b in zip((frozen, conv, iters, counter), plain):
        assert torch.equal(a, b)


def test_syndrome_scratch_is_reset(cuda):
    """Two launches in a row: failing bits, then bits that pass. The second
    launch's flags are 0, so the first left no flag word or ticket behind,
    and the scratch is all zero after both."""
    layout, (_, post, _) = _syndrome_bits("DVB-S2 R1_4short", cuda)
    assert bool(fused_bp2.fused_syndrome_bits(post, layout).any())
    flags = fused_bp2.fused_syndrome_bits(torch.zeros_like(post), layout)
    assert not bool(flags.any())
    conv = torch.zeros(post.shape[0] * 4, dtype=torch.bool, device=cuda)
    iters = torch.zeros_like(conv, dtype=torch.int32)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    frozen = torch.empty_like(post)
    fused_bp2.fused_syndrome_freeze(post, frozen, conv, iters, 1, counter, layout)
    first = int(counter)
    fused_bp2.fused_syndrome_freeze(post, frozen, conv, iters, 2, counter, layout)
    assert first > 0 and int(counter) == first
    stream = torch.cuda.current_stream(post.device).cuda_stream
    assert not bool(fused_bp2._SCRATCH[post.device, stream].any())


def test_syndrome_freeze_on_two_streams(cuda):
    """Freezes of two loop states on two streams, launched in turns
    without waiting: each stream has its own scratch, so each state ends
    as the plain version's, bit for bit."""
    layout, (_, post, mixed) = _syndrome_bits("DVB-S2 R1_4short", cuda)
    steps = (post, mixed, post, torch.zeros_like(post))
    streams = (torch.cuda.Stream(cuda), torch.cuda.Stream(cuda))
    states, plains = [], []
    for seed in (4, 5):
        conv, iters = _freeze_state(post.shape[0], cuda, seed)
        state = (torch.zeros_like(post), conv, iters,
                 torch.zeros(1, dtype=torch.int32, device=cuda))
        plains.append(tuple(x.clone() for x in state))
        states.append(state)
    torch.cuda.synchronize(cuda)
    for _ in range(10):
        for it, bits in enumerate(steps, start=1):
            for stream, state in zip(streams, states):
                with torch.cuda.stream(stream):
                    fused_bp2.fused_syndrome_freeze(bits, *state[:3], it, state[3], layout)
    torch.cuda.synchronize(cuda)
    for _ in range(10):
        for it, bits in enumerate(steps, start=1):
            for plain in plains:
                fused_bp2.fused_syndrome_freeze_reference(bits, *plain[:3], it, plain[3], layout)
    for state, plain in zip(states, plains):
        for a, b in zip(state, plain):
            assert torch.equal(a, b)
    for stream in streams:
        assert not bool(fused_bp2._SCRATCH[post.device, stream.cuda_stream].any())


def test_syndrome_counter(cuda):
    """The counter holds the unconverged frames whatever it held before,
    over many tiles (R1_4short, 32 tiles; C2 at 16)."""
    for code in ("DVB-S2 R1_4short", "CCSDS C2"):
        layout, (_, _, mixed) = _syndrome_bits(code, cuda)
        conv, iters = _freeze_state(mixed.shape[0], cuda, seed=3)
        counter = torch.full((1,), 12345, dtype=torch.int32, device=cuda)
        flags = fused_bp2.fused_syndrome_bits_reference(mixed, layout).reshape(-1)
        left = int((~(conv | (flags == 0))).sum())
        fused_bp2.fused_syndrome_freeze(mixed, torch.empty_like(mixed), conv, iters, 1,
                                        counter, layout)
        assert int(counter) == left > 0


def test_syndrome_kernel_raises_on_other_tile_widths(cuda):
    """The syndrome kernel takes a check lane's four frames: tiles of 8
    raise before any launch, for the flags and for the freeze."""
    layout, (_, post, _) = _syndrome_bits("5G BG2 z=16", cuda)
    wide = post.reshape(post.shape[0] // 2, *post.shape[1:3], 8).contiguous()
    with pytest.raises(ValueError, match="tile width 8"):
        fused_bp2.fused_syndrome_bits(wide, layout)
    conv = torch.zeros(wide.shape[0] * 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="tile width 8"):
        fused_bp2.fused_syndrome_freeze(wide, torch.empty_like(wide), conv,
                                        torch.zeros_like(conv, dtype=torch.int32), 1,
                                        torch.zeros(1, dtype=torch.int32, device=cuda), layout)


# -- the generic parity-check path (torch ops, no kernel of its own) -----------

GENERIC_NAMES = ["Minsumf32", "Minsumbf16", "Normminsumbf16", "HLMinsumf32", "HLMinsumbf16",
                 "Minstarapproxi8", "Aminstari8JonesPartialHardLimitDeg1Clip",
                 "HLMinstarapproxi8", "HLAminstari8PartialHardLimit"]


def _generic_case(code):
    """(h, LLRs (64, n) on the CPU) of a generic-path code: MacKay-Neal
    n = 1024 (``results/mn_512_1024_sys.alist``) or 5G BG2 z=16, frames at
    a spread of noise that gives converged and failed frames."""
    import pathlib

    from ldpc_toolbox_torch.sparse import SparseMatrix

    if code == "mn":
        root = pathlib.Path(__file__).resolve().parent.parent
        h, sigmas = SparseMatrix.from_alist_file(root / "results/mn_512_1024_sys.alist"), (0.7, 0.95)
    else:
        h, sigmas = BaseGraph.BG2.h(16), (1.0, 1.6)
    rng = np.random.default_rng(8)
    sigma = np.linspace(*sigmas, 64)[:, None]
    x = -1.0 + sigma * rng.standard_normal((64, h.num_cols))
    return h, torch.from_numpy(((-2.0 / sigma**2) * x).astype(np.float32))


@pytest.mark.parametrize("decoder", GENERIC_NAMES)
@pytest.mark.parametrize("code", ["mn", "5G BG2 z=16"])
def test_generic_decode_on_the_card_equals_the_cpu(cuda, code, decoder):
    """The generic decodes (min-sum and i8 names, both schedules) give the
    same bits, iterations and success flags on the card as on the CPU: the
    same torch ops, every degree-axis sum folded in slot order."""
    h, llrs = _generic_case(code)
    cpu = Decoder(h, decoder, device="cpu").decode_batch(llrs, 20)
    dev = Decoder(h, decoder).decode_batch(llrs, 20)
    for key in ("codeword", "iterations", "success"):
        assert dev[key].device.type == "cuda"
        assert torch.equal(dev[key].cpu(), cpu[key]), key
    assert 0 < int(cpu["success"].sum()) < 64


def test_generic_decodes_on_two_streams(cuda):
    """Two generic decodes, each on a stream of its own and launched in
    turns, each equal to its decode on the CPU."""
    h, llrs = _generic_case("mn")
    names = ("Minsumbf16", "HLMinstarapproxi8")
    decoders = [Decoder(h, name) for name in names]
    streams = (torch.cuda.Stream(cuda), torch.cuda.Stream(cuda))
    dev_llrs = llrs.to(cuda)
    torch.cuda.synchronize(cuda)
    outs = [None, None]
    for i, (dec, stream) in enumerate(zip(decoders, streams)):
        with torch.cuda.stream(stream):
            outs[i] = dec.decode_batch(dev_llrs, 20)
    torch.cuda.synchronize(cuda)
    for name, out in zip(names, outs):
        cpu = Decoder(h, name, device="cpu").decode_batch(llrs, 20)
        for key in ("codeword", "iterations", "success"):
            assert torch.equal(out[key].cpu(), cpu[key]), (name, key)


# -- the probes (ldpc_toolbox_torch/probes, csrc/probes.cu and
# csrc/probe_layered.cu), small sizes --------------------------------------


#: rows of 16 bytes in a block of the probes' copy stream (``copybw.BLOCK_BYTES``)
_BLOCK_ROWS = 8192 // 16
#: 16-byte rows the copy-stream cases stream: not a whole number of blocks,
#: shorter than one, exactly one, and a prime number of blocks and 3 rows
#: (the last block's share is 48 bytes)
_STREAM_ROWS = {"13.25 blocks": 13 * _BLOCK_ROWS + 128, "under a block": 128,
                "one block": _BLOCK_ROWS, "3203 blocks and 48 bytes": 3203 * _BLOCK_ROWS + 3}


@pytest.mark.parametrize("shape,dtype", [
    ((3, 7, 40, 128), torch.bfloat16),  # not a whole number of blocks
    ((2, 5, 24, 128), torch.float32),
    ((400, 7, 64, 128), torch.bfloat16),  # more blocks than the card runs at once
    *[((1, 1, rows, 8), torch.bfloat16) for rows in _STREAM_ROWS.values()],
    *[((1, 1, rows, 4), torch.float32) for rows in _STREAM_ROWS.values()],
])
def test_probe_stream_slabs(cuda, shape, dtype):
    from ldpc_toolbox_torch.probes import _kernels, copybw

    assert copybw.BLOCK_BYTES == 16 * _BLOCK_ROWS == _kernels.lib().ldpc_probe_stream_block_bytes()
    src = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    src = (src * 300).to(cuda, dtype)
    before = copybw.stream_slabs.launches
    out = copybw.stream_slabs(src)
    assert copybw.stream_slabs.launches == before + 1
    assert torch.equal(out, copybw.stream_slabs_reference(src))


@pytest.mark.parametrize("rows", list(_STREAM_ROWS.values()), ids=list(_STREAM_ROWS))
def test_probe_plane_copy(cuda, rows):
    """P4's copy on the copy stream's kernel over the same byte counts."""
    from ldpc_toolbox_torch.probes import v2

    src = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 1, 1, rows, 8)))
    src = src.to(cuda, torch.bfloat16)
    before = v2.plane_copy.launches
    out = v2.plane_copy(src)
    assert v2.plane_copy.launches == before + 1
    assert torch.equal(out, v2.plane_copy_reference(src))


def test_probe_stream_on_another_stream(cuda):
    """The copy stream launches on the caller's current stream: a second
    launch, on another stream, set up by nothing but its arguments, is
    right and ordered after the work that stream waits for."""
    from ldpc_toolbox_torch.probes import copybw, v2

    gen = torch.Generator(device=cuda).manual_seed(8)
    src = torch.randn((2, 3, 7, 40, 16), generator=gen, device=cuda).to(torch.bfloat16)
    copybw.stream_slabs(src[0])
    v2.plane_copy(src)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        plus, copy = copybw.stream_slabs(src[0]), v2.plane_copy(src)
    side.synchronize()
    assert torch.equal(plus, copybw.stream_slabs_reference(src[0]))
    assert torch.equal(copy, src)


@pytest.mark.parametrize("mode", ["add", "fma", "sel", "roll"])
def test_probe_alu_chain(cuda, mode):
    from ldpc_toolbox_torch.probes import vpu_peak

    rng = np.random.default_rng(2)
    for shape in ((3, 40, 64), (2, 360, 128)):
        x = torch.from_numpy(rng.uniform(0.4, 0.6, shape).astype(np.float32)).to(cuda)
        out = vpu_peak.alu_chain(x, mode, 300)
        ref = vpu_peak.alu_chain_reference(x, mode, 300)
        # fma too: from inputs in [0.4, 0.6) one rounding and two agree
        assert torch.equal(out, ref)
    if mode == "roll":
        # round counts 0, 1, the shift, odd; one plane and the tool's 132;
        # every Z the kernel is built for, B = 44 cutting warps across
        # planes and leaving the last one part empty
        cases = [((1, 360, 128), r) for r in (0, 1, 37, 301)] + [((132, 360, 128), 37)]
        cases += [((3, z, 44), 37) for z in sorted(vpu_peak.ROLL_LANES)]
        for shape, rounds in cases:
            x = torch.from_numpy(rng.uniform(0.4, 0.6, shape).astype(np.float32)).to(cuda)
            before = vpu_peak.alu_chain.launches
            out = vpu_peak.alu_chain(x, mode, rounds)
            assert vpu_peak.alu_chain.launches == before + 1
            assert torch.equal(out, vpu_peak.alu_chain_reference(x, mode, rounds)), (shape, rounds)
    # roll's kernel is built for a few Z: any other raises, naming them
    for z in (8, 36, 361, 384):
        with pytest.raises(ValueError, match=r"roll's kernel is built for Z in \[24, 40, 360\], "
                                             f"not {z}$"):
            vpu_peak.alu_chain(torch.zeros((1, z, 40), device=cuda), "roll", 1)


@pytest.mark.parametrize("mode", ["dma", "roll0", "switch", "dynroll"])
def test_probe_rotated_gather(cuda, mode):
    from ldpc_toolbox_torch.probes import roll

    src, planes, shifts = roll.inputs(seed=4, device=cuda, nbt=2, p=10, z=24, bt=16, g=3)
    out = roll.rotated_gather(src, planes, shifts, mode)
    assert torch.equal(out, roll.rotated_gather_reference(src, planes, shifts, mode))


@pytest.mark.parametrize("mode", ["copy", "contig", "scatw", "scatw_roll"])
def test_probe_minsum_planes(cuda, mode):
    from ldpc_toolbox_torch.probes import v2

    for bt in (8, 16):
        src, dest, shifts = v2.inputs(bt, seed=5, device=cuda, b=32, g=3, d=7, z=24)
        out = v2.run(mode, src, dest, shifts)
        ref = (v2.plane_copy_reference(src) if mode == "copy"
               else v2.minsum_planes_reference(src, mode, dest, shifts))
        assert torch.equal(out, ref)


@pytest.mark.parametrize("code", ["R1_4short", "5G BG2 z=16"])
@pytest.mark.parametrize("decoder", ["HLMinsumbf16", "HLMinsumf32"])
def test_probe_layered_sweep_parts(cuda, code, decoder):
    """Each variant of the probe's sweep equals its plain version over two
    sweeps, and the whole sweep is ``fused_layered_iteration``, the
    streaming sweep itself: its launch counted there, not as the probe's."""
    from ldpc_toolbox_torch.probes import layered_variants

    lg = (lifted_graph_for(DvbCode.R1_4short) if code == "R1_4short"
          else LiftedGraph.from_sparse(BaseGraph.BG2.h(16), *nr5g_maps(BaseGraph.BG2, 16)))
    layout = lifted_layered.device_layout(lg, cuda)
    rule = fused_bp2.rule_for(make_arithmetic(decoder)[1])
    rng = np.random.default_rng(6)
    qv0 = torch.from_numpy(rng.standard_normal((3, layout.VG, layout.Z, 4), dtype=np.float32) * 4)
    rcv0 = torch.from_numpy(rng.standard_normal((3, layout.E, layout.Z, 4), dtype=np.float32))
    qv0, rcv0 = qv0.to(cuda), rcv0.to(cuda, rule.storage_dtype)
    for variant in layered_variants.VARIANTS:
        mine = (qv0.clone(), rcv0.clone())
        plain = (qv0.clone(), rcv0.clone())
        for _ in range(2):
            out = layered_variants.layered_sweep_parts(*mine, layout, rule, variant)
            ref = layered_variants.layered_sweep_parts_reference(*plain, layout, rule, variant)
            for a, b in zip(out, ref):
                assert torch.equal(a, b), variant
    probe, sweep = layered_variants.layered_sweep_parts.launches, fused_layered_iteration.launches
    whole = layered_variants.layered_sweep_parts(qv0.clone(), rcv0.clone(), layout, rule, "full")
    assert layered_variants.layered_sweep_parts.launches == probe
    assert fused_layered_iteration.launches == sweep + 1
    for a, b in zip(whole, fused_layered_iteration(qv0.clone(), rcv0.clone(), layout, rule)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("decoder", ["HLMinsumbf16", "Minsumbf16"], ids=["layered", "flooding"])
def test_telemetry_of_a_profiled_step(cuda, decoder, tmp_path):
    """Two ``ber`` steps profiled on the card (each in a ``pb.step`` range,
    as the benchmark runs them) export every program span twice, the
    counters' read waits for the device in a synchronising call, and the
    decode's tile counter equals the count from the frames' iterations."""
    from portbench import program_trace

    lg = lifted_graph_for(DvbCode.R1_4short)
    test = BerTestBuilder(
        h=DvbCode.R1_4short.h(), lifted_graph=lg, decoder_implementation=decoder,
        max_iterations=30, batch_size=64, device="cuda",
    ).build()
    test.step(step_generator(5, 1, 0, cuda), 1.05)  # loads the kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            with record_function("pb.step"):
                test.step(step_generator(5, 0, i, cuda), 1.05)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    spans = Counter(e["name"] for e in data["traceEvents"]
                    if e.get("cat") == "user_annotation" and e["name"].startswith("ldpc."))
    assert spans == Counter({"ldpc." + name: 2 for name in program_trace.ORDER})
    prog = program_trace.reduce(data)
    assert prog.steps == 2
    assert prog.syncs.get("counters.read", 0) >= 2
    assert prog.device_s.get("decode.kernel", 0.0) > 0
    numbers = program_trace.per_step(prog)
    assert numbers["syncs_per_step"] >= 1 and numbers["launches_per_step"] > 0

    _, arith = make_arithmetic(decoder)
    with telemetry.counting() as counts:
        out = lifted_decode_for(test.schedule)(lg, arith, _llrs(lg.n, 64, 1.05, 5, cuda), 30)
    iters = out["iterations"].reshape(-1, fused_bp2.BT)
    assert 0 < int(iters.min()) < int(iters.max())
    assert counts == {"tile_iterations": int(iters.amax(dim=1).sum())}
