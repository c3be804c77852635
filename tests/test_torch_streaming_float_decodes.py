"""The streaming decodes of the float names (``resident=False``: the
phases or the sweep under staged compaction) against the JAX package's jnp
paths (``fused=False``, with XLA's own transcendentals; interpret mode
would take minutes a decode), equal in success, iterations and codewords
on every frame, on the workloads on which tests/test_torch_float.py and
tests/test_torch_float_flooding.py hold the resident decodes to those
paths: DVB-S2 R1_4short (layered B = 128, sigma 0.9, seed 5, 8
iterations; flooding noisy codewords of the JAX encoder, B = 128, sigma
0.85, seed 2, 12 iterations) and 5G BG2 z=16 (a mix of converged and
failed frames). Each also equals the port's resident decode of the same
name."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode as jax_flooding
from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode as jax_layered
from ldpc_toolbox_tpu.encoder import Encoder as JaxEncoder
from ldpc_toolbox_torch.decoder import lifted_flooding, lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic

from torch_parity import assert_same_decode, lifted_graphs, llrs, parity_check

#: (code, schedule) -> (batch, sigma, iterations, seed, names)
CASES = {
    ("R1_4short", "layered"): (128, 0.9, 8, 5, ["HLPhif32", "HLTanhf32",
                                                "HLMinstarapproxf32", "HLPhif64"]),
    ("bg2z16", "layered"): (96, 1.45, 8, 5, ["HLAminstarf64"]),
    ("R1_4short", "flooding"): (128, 0.85, 12, 2, ["Phif32", "Minstarapproxf32",
                                                   "Aminstarf32", "Phif64"]),
    ("bg2z16", "flooding"): (96, 1.3, 10, 5, ["Tanhf64"]),
}


@functools.cache
def _inputs(code, schedule):
    """The case's LLRs: noisy codewords of the JAX package's encoder (DVB-S2
    flooding, as tests/test_torch_float_flooding.py makes them), or the
    all-zero codeword."""
    jlg, tlg = lifted_graphs(code)
    batch, sigma, _, seed, _ = CASES[code, schedule]
    if (code, schedule) != ("R1_4short", "flooding"):
        return jlg, tlg, llrs(tlg.n, batch, sigma, seed=seed)
    enc = JaxEncoder(parity_check(code, jax_codes))
    rng = np.random.default_rng(seed)
    cw = np.asarray(enc.encode_batch(rng.integers(0, 2, size=(batch, enc.k))))
    x = np.where(cw == 0, -1.0, 1.0) + sigma * rng.standard_normal(cw.shape)
    return jlg, tlg, ((-2.0 / sigma**2) * x).astype(np.float32)


@pytest.mark.parametrize(
    "code,schedule,decoder",
    [(c, s, n) for (c, s), case in CASES.items() for n in case[4]],
)
def test_streaming_decode_matches_jax(code, schedule, decoder):
    jlg, tlg, x = _inputs(code, schedule)
    iters = CASES[code, schedule][2]
    _, ja = jax_factory.make_arithmetic(decoder)
    _, ta = make_arithmetic(decoder)
    if schedule == "layered":
        jax_decode, decode = jax_layered, lifted_layered.lifted_layered_decode
    else:
        jax_decode, decode = jax_flooding, lifted_flooding.lifted_flooding_decode
    jout = jax_decode(jlg, ja, jnp.asarray(x), iters, fused=False)
    stream = decode(tlg, ta, torch.from_numpy(x), iters, resident=False)
    if code == "bg2z16":
        assert_same_decode(jout, stream)
    else:  # most frames converge on these workloads
        for key in ("success", "iterations", "codeword"):
            np.testing.assert_array_equal(np.asarray(jout[key]), stream[key].numpy(),
                                          err_msg=key)
        assert int(stream["success"].sum()) >= 100
    resident = decode(tlg, ta, torch.from_numpy(x), iters)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(stream[key], resident[key]), key
