"""The port's generic parity-check decodes on other codes than the
MacKay-Neal one of tests/test_torch_generic_decode.py, against the JAX
package's ``Decoder(h)`` on the CPU, bit for bit in success, iterations and
codewords: 5G BG2 z=16, AR4JA K=1024 rate 1/2, CCSDS C2 (check degree 32)
and a small staircase code (m = 48), whose layered schedule has one check
a layer and so runs the serial sweep. 12 frames a case at a noise range
that gives a mix of converged and failed frames, one frame already a
codeword, at most 15 iterations; a min-sum, two i8 and a float name (the
float one with torch's transcendentals on the JAX side, as in
tests/test_torch_generic_decode.py). And the generic decode of AR4JA
against the port's lifted plain decode of the same code (``Minsumf32``,
both schedules), which the JAX package also holds equal
(tests/test_decoder.py test_decoder_routes_code_objects_to_lifted_path)."""

import functools

import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu import sparse as jax_sparse
from ldpc_toolbox_tpu.decoder import Decoder as JaxDecoder
from ldpc_toolbox_tpu.decoder import arithmetic as jax_arithmetic
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch import sparse as torch_sparse
from ldpc_toolbox_torch.decoder import Decoder
from ldpc_toolbox_torch.decoder.layout import DecodeGraph

from torch_parity import code_objects, generic_h, mixed_llrs, torch_transcendentals

#: code -> the noise sigma range of its frames
SIGMAS = {"bg2z16": (1.0, 1.6), "ar4ja-1/2": (0.85, 1.1), "ccsds-c2": (0.44, 0.54),
          "staircase": (0.5, 0.8)}
NAMES = ["Minsumbf16", "HLMinstarapproxi8", "Aminstari8JonesPartialHardLimitDeg1Clip",
         "HLPhif64"]
BATCH, ITERATIONS = 12, 15


@functools.cache
def _codes(code):
    th = generic_h(code, torch_sparse, torch_codes)
    return generic_h(code, jax_sparse, jax_codes), th, DecodeGraph.from_sparse(th)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("code", list(SIGMAS))
def test_generic_decode_matches_jax_on_other_codes(code, name, monkeypatch):
    jh, th, graph = _codes(code)
    llrs = mixed_llrs(th.num_cols, BATCH, seed=4, sigmas=SIGMAS[code])
    if "Phi" in name:
        torch_transcendentals(monkeypatch, jax_arithmetic,
                              ("exp", "expm1", "log", "log1p"))
    jout = JaxDecoder(jh, name).decode_batch(llrs, ITERATIONS)
    out = Decoder(graph, name, device="cpu").decode_batch(torch.from_numpy(llrs), ITERATIONS)
    for key in ("success", "iterations", "codeword"):
        np.testing.assert_array_equal(np.asarray(jout[key]), out[key].numpy(), err_msg=key)
    success = out["success"].numpy()
    assert 0 < success.sum() < BATCH, success
    assert out["iterations"][0] == 0
    if code == "staircase":
        assert graph.layers.shape == (graph.m, 1)


@pytest.mark.parametrize("name", ["Minsumf32", "HLMinsumf32"])
def test_generic_decode_equals_lifted_decode(name):
    _, th, graph = _codes("ar4ja-1/2")
    llrs = torch.from_numpy(mixed_llrs(th.num_cols, BATCH, seed=5, sigmas=SIGMAS["ar4ja-1/2"]))
    generic = Decoder(th, name, device="cpu").decode_batch(llrs, ITERATIONS)
    lifted_dec = Decoder(code_objects("ar4ja-1/2", torch_codes), name, device="cpu")
    assert lifted_dec.lifted is not None and lifted_dec.graph is None
    lifted = lifted_dec.decode_batch(llrs, ITERATIONS)
    for key in ("success", "iterations", "codeword"):
        torch.testing.assert_close(generic[key], lifted[key], rtol=0, atol=0, msg=key)
    assert 0 < int(generic["success"].sum()) < BATCH
