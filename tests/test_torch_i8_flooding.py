"""The port's i8 flooding decodes against the JAX package's plane-gather
path (``lifted_flooding_decode(..., fused=False)``), bit for bit in
success, iterations and codewords: all 16 flooding i8 names on 5G BG2 z=16
(whose degree-1 extension columns are where Deg1Clip acts), both families
on DVB-S2 R1_4short and CCSDS C2. JAX's own tests hold its i8 Pallas
kernels equal to that path (tests/test_lifted.py
test_fused_i8_matches_plane_gather_path)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode as jax_flooding
from ldpc_toolbox_torch.decoder import Decoder

from ldpc_toolbox_torch import codes as torch_codes
from torch_parity import (
    I8_NAMES,
    assert_same_decode,
    code_objects,
    lifted_graphs,
    llrs,
    strong_llrs,
)

#: code -> (batch, sigma, iterations); the 5G BG2 z=16 batch holds 64
#: large-magnitude frames besides, where the clips and the hard limit act
CASES = {"bg2z16": (136, 1.3, 10), "R1_4short": (64, 0.9, 8),
         "ccsds-c2": (48, 0.48, 6)}
NAMES = {"bg2z16": I8_NAMES,
         "R1_4short": ["Minstarapproxi8Deg1Clip", "Aminstari8JonesPartialHardLimit"],
         "ccsds-c2": ["Minstarapproxi8PartialHardLimit", "Aminstari8"]}


@functools.cache
def _inputs(code):
    jlg, tlg = lifted_graphs(code)
    batch, sigma, _ = CASES[code]
    x = llrs(tlg.n, batch, sigma, seed=5)
    if code == "bg2z16":
        x = np.concatenate([x, strong_llrs(tlg.n, 64, seed=6)])
    return jlg, x


@pytest.mark.parametrize("code,decoder", [(c, n) for c, ns in NAMES.items() for n in ns])
def test_flooding_decode_matches_jax(code, decoder):
    jlg, x = _inputs(code)
    iters = CASES[code][2]
    _, ja = jax_factory.make_arithmetic(decoder)
    jout = jax_flooding(jlg, ja, jnp.asarray(x), iters)
    dec = Decoder(code_objects(code, torch_codes), decoder, device="cpu")
    assert dec.schedule == "flooding"
    assert_same_decode(jout, dec.decode_batch(x, max_iterations=iters))
