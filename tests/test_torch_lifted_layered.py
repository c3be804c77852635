"""The port's lifted layered decode against the JAX package's jnp path
(``fused=False``), bit for bit in success, iterations and codewords, on
both of the port's CPU routes: the plain twin of the jnp path and the
decoder's tile glue (which runs the kernels' plain versions on the CPU:
the compressed one for the f32 name, the message one for bf16)."""

import functools

import jax.numpy as jnp
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder import lifted_layered as jax_layered
from ldpc_toolbox_torch.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_torch.codes.nr5g import BaseGraph
from ldpc_toolbox_torch.decoder import Decoder
from ldpc_toolbox_torch.decoder import lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic

from torch_parity import assert_same_decode, lifted_graphs, llrs

# (code, batch, sigma, iterations): R1_4short holds two edges into one
# variable group in four check groups; B=200 leaves a partial tile
CASES = {
    "R1_4short": (128, 1.05, 8),
    "bg2z16": (200, 1.3, 10),
}
DECODERS = ["Minsumf32", "Minsumbf16", "Normminsumbf16"]


@functools.cache
def _case(code, decoder):
    """(port LiftedGraph, LLRs, JAX jnp-path output) of one case."""
    jlg, tlg = lifted_graphs(code)
    batch, sigma, iters = CASES[code]
    x = llrs(tlg.n, batch, sigma, seed=5)
    _, ja = jax_factory.make_arithmetic(decoder)
    out = jax_layered.lifted_layered_decode(jlg, ja, jnp.asarray(x), iters)
    return tlg, x, out


@pytest.mark.parametrize("route", ["plain", "tiles"])
@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("code", list(CASES))
def test_lifted_layered_matches_jax(code, decoder, route):
    tlg, x, jout = _case(code, decoder)
    decode = {
        "plain": lifted_layered.plain_layered_decode,
        "tiles": lifted_layered.lifted_layered_decode,
    }[route]
    _, ta = make_arithmetic(decoder)
    tout = decode(tlg, ta, torch.from_numpy(x), CASES[code][2])
    assert tout["codeword"].dtype == torch.uint8
    assert tout["iterations"].dtype == torch.int32
    assert_same_decode(jout, tout)


def test_decoder_class():
    _, x, jout = _case("bg2z16", "Minsumbf16")
    dec = Decoder((BaseGraph.BG2, 16), "HLMinsumbf16", device="cpu")
    assert_same_decode(jout, dec.decode_batch(x, max_iterations=10))
    one = dec.decode(x[3], max_iterations=10)
    assert one.success == bool(jout["success"][3])
    assert one.iterations == int(jout["iterations"][3])
    assert (one.codeword == jout["codeword"][3]).all()
    # a name without HL decodes flooding: the same frames through the
    # flooding route, where converged frames decode the all-zero codeword
    flood = Decoder((BaseGraph.BG2, 16), "Minsumbf16", device="cpu")
    assert flood.schedule == "flooding"
    fout = flood.decode_batch(x, max_iterations=10)
    ok = fout["success"]
    assert 0 < int(ok.sum()) < ok.numel()
    assert not fout["codeword"][ok].any()
    assert (fout["iterations"][~ok] == 10).all()
    assert Decoder(DvbCode.R1_4short, "HLPhif32", device="cpu").schedule == "layered"
    # a parity-check matrix takes the generic path (decoder/layered.py)
    generic = Decoder(DvbCode.R1_4short.h(), "HLMinsumbf16", device="cpu")
    assert generic.lifted is None and generic.n == DvbCode.R1_4short.n
    with pytest.raises(ValueError):
        dec.decode_batch(x[:, :-1])
