"""The port's generic parity-check decodes (``Decoder(SparseMatrix)``,
``decoder/flooding.py`` and ``decoder/layered.py``) against the JAX
package's ``Decoder(h)`` on the CPU, for all 44 decoder names, on the
MacKay-Neal (3,6) n = 1024 code of ``results/mn_512_1024_sys.alist``: 16
frames at noise sigma 0.7 to 0.95, one of them already a codeword
(iteration 0), at most 20 iterations. Success, iterations and codewords
are equal on every frame, bit for bit, with a mix of converged and failed
frames.

The float names run the JAX arithmetic with torch's exp, expm1, log, log1p,
tanh and atanh (``torch_parity.torch_transcendentals``; XLA's own CPU
approximations differ by ulps, and tests/test_torch_generic.py holds the
rules to within the float tolerances). Two layered names,
``HLNormminsumf32`` and ``HLNormminsumbf16``, are held to the JAX decode
run with jit disabled, op by op: jitted, XLA's CPU compiler contracts the
layered update's ``(sign * loo) * 0.75 - Rold`` into one fused
multiply-add, which rounds once where the JAX source (and the port, on
either device) rounds the normalized message first; the two then differ
in the last bit of Qv on some frames."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu import sparse as jax_sparse
from ldpc_toolbox_tpu.decoder import Decoder as JaxDecoder
from ldpc_toolbox_tpu.decoder import arithmetic as jax_arithmetic
from ldpc_toolbox_tpu.decoder import layered_decode as jax_layered_decode
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch import sparse as torch_sparse
from ldpc_toolbox_torch.decoder import DECODER_IMPLEMENTATIONS, Decoder
from ldpc_toolbox_torch.decoder.layout import DecodeGraph

from torch_parity import generic_h, mixed_llrs, torch_transcendentals

FLOATS = ("Phi", "Tanh", "Minstarapprox", "Aminstar")
TRANSCENDENTALS = ("exp", "expm1", "log", "log1p", "tanh", "arctanh")
#: layered names held to the JAX decode with jit disabled (the docstring)
EAGER = ("HLNormminsumf32", "HLNormminsumbf16")
BATCH, ITERATIONS = 16, 20


@functools.cache
def _codes():
    jh = generic_h("mn", jax_sparse, jax_codes)
    th = generic_h("mn", torch_sparse, torch_codes)
    return jh, th, DecodeGraph.from_sparse(th)


def _is_float(name):
    return name.removeprefix("HL").startswith(FLOATS)


@pytest.mark.parametrize("name", list(DECODER_IMPLEMENTATIONS))
def test_generic_decode_matches_jax(name, monkeypatch):
    jh, th, graph = _codes()
    llrs = mixed_llrs(th.num_cols, BATCH, seed=3)
    if _is_float(name):
        torch_transcendentals(monkeypatch, jax_arithmetic, TRANSCENDENTALS)
    jdec = JaxDecoder(jh, name)
    if name in EAGER:
        with jax.disable_jit():
            jout = jax_layered_decode(jdec.graph, jdec.arithmetic, jnp.asarray(llrs), ITERATIONS)
    else:
        jout = jdec.decode_batch(llrs, ITERATIONS)
    dec = Decoder(graph if name.startswith("HL") else th, name, device="cpu")
    assert dec.lifted is None and dec.n == th.num_cols
    assert dec.schedule == ("layered" if name.startswith("HL") else "flooding")
    out = dec.decode_batch(torch.from_numpy(llrs), ITERATIONS)
    assert out["codeword"].dtype == torch.uint8 and out["iterations"].dtype == torch.int32
    assert out["success"].dtype == torch.bool
    for key in ("success", "iterations", "codeword"):
        np.testing.assert_array_equal(np.asarray(jout[key]), out[key].numpy(), err_msg=key)
    success = out["success"].numpy()
    assert 0 < success.sum() < BATCH, success
    assert out["iterations"][0] == 0 and success[0]
