"""Two code families that ``Decoder`` takes and the other tests do not
decode: CCSDS AR4JA (K = 1024, rates 1/2 and 4/5: Z = 128 and 32,
punctured columns) and 5G NR base graph 1 at Z = 16 (check degree 19, the
kernels' 32 bucket). Each decodes on the CPU through ``Decoder`` against
the JAX package's jnp layered path and plane-gather flooding path, with a
min-sum bf16 name and an i8 name a schedule.

The layered decodes and the i8 flooding decode are held bit for bit. The
plane-gather path sums the min-sum variable rule in another order than the
kernels (tests/test_torch_flooding.py), so ``Minsumbf16`` flooding is held
to that path's bar: equal success and iterations, and equal codewords of
the converged frames; its LLRs are bf16 values, so the kernels' cast of
the channel to bf16 changes nothing."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode as jax_flooding
from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode as jax_layered
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.decoder import Decoder

from torch_parity import assert_same_decode, code_objects, lifted_graphs, llrs

#: code -> (noise sigmas, 16 frames each, so that every name sees a
#: convergence mix; iterations)
CASES = {
    "ar4ja-1/2": ((0.75, 0.85, 0.95), 8),
    "ar4ja-4/5": ((0.5, 0.6, 0.7), 8),
    "bg1z16": ((0.9, 1.0, 1.1), 8),
}
NAMES = ["HLMinsumbf16", "HLMinstarapproxi8", "Minsumbf16", "Minstarapproxi8"]


@functools.cache
def _case(code, decoder):
    jlg, tlg = lifted_graphs(code)
    sigmas, iters = CASES[code]
    x = np.concatenate([llrs(tlg.n, 16, s, seed=7 + i) for i, s in enumerate(sigmas)])
    # bf16 values (exact in f32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    schedule, ja = jax_factory.make_arithmetic(decoder)
    decode = jax_layered if schedule == "layered" else jax_flooding
    return x, decode(jlg, ja, jnp.asarray(x), iters)


@pytest.mark.parametrize("decoder", NAMES)
@pytest.mark.parametrize("code", list(CASES))
def test_family_decodes_match_jax(code, decoder):
    x, jout = _case(code, decoder)
    dec = Decoder(code_objects(code, torch_codes), decoder, device="cpu")
    tout = dec.decode_batch(x, max_iterations=CASES[code][1])
    if decoder != "Minsumbf16":
        assert_same_decode(jout, tout)
        return
    s = np.asarray(jout["success"])
    np.testing.assert_array_equal(s, tout["success"].numpy())
    np.testing.assert_array_equal(np.asarray(jout["iterations"]), tout["iterations"].numpy())
    np.testing.assert_array_equal(np.asarray(jout["codeword"])[s], tout["codeword"].numpy()[s])
    assert 0 < s.sum() < s.size
