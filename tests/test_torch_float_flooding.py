"""The port's float flooding decodes against the JAX package's plane-gather
path (``lifted_flooding_decode``, ``fused=False``), equal in success,
iterations and codewords on every frame, on the workload on which the JAX
package holds its float Pallas kernels to that path (tests/test_lifted.py
test_fused_float_matches_plane_gather_path: DVB-S2 R1_4short, noisy
codewords of its encoder, B = 128, sigma 0.85, seed 2, 12 iterations) and
on 5G BG2 z=16; the float names' defaults and refusals: ``Phif64`` is
the default of ``Decoder``, of ``BerTestParameters`` and of the ``ber``
command; a check wider than MinstarApprox's kernels take (32) raises and
names the cap; and ``resident=False`` of a float name equals its resident
decode. The rules and the layered decodes are in test_torch_float.py, the
streaming path against the JAX package in test_torch_streaming_float*.py."""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode as jax_flooding
from ldpc_toolbox_tpu.encoder import Encoder as JaxEncoder
from ldpc_toolbox_torch import cli
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.decoder import Decoder, arithmetic
from ldpc_toolbox_torch.decoder import lifted_flooding, lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted import LiftedGraph
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.simulation.ber import BerTestParameters
from ldpc_toolbox_torch.sparse import SparseMatrix

from torch_parity import (
    assert_same_decode,
    code_objects,
    lifted_graphs,
    llrs,
    parity_check,
)

from ldpc_toolbox_tpu import codes as jax_codes

#: flooding decode cases: code -> (batch, sigma, iterations, seed, names)
CASES = {
    "R1_4short": (128, 0.85, 12, 2, ["Phif32", "Tanhf32", "Minstarapproxf32",
                                     "Aminstarf32", "Phif64"]),
    "bg2z16": (96, 1.3, 10, 5, ["Tanhf64"]),
}


@functools.cache
def _inputs(code):
    """The case's LLRs: noisy codewords of the JAX package's encoder, as
    its own test makes them (DVB-S2), or the all-zero codeword (5G)."""
    jlg, tlg = lifted_graphs(code)
    batch, sigma, _, seed, _ = CASES[code]
    if code != "R1_4short":
        return jlg, llrs(tlg.n, batch, sigma, seed=seed)
    h = parity_check(code, jax_codes)
    enc = JaxEncoder(h)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, size=(batch, enc.k))
    cw = np.asarray(enc.encode_batch(msgs))
    x = np.where(cw == 0, -1.0, 1.0) + sigma * rng.standard_normal(cw.shape)
    return jlg, ((-2.0 / sigma**2) * x).astype(np.float32)


@pytest.mark.parametrize("code,decoder", [(c, n) for c, case in CASES.items() for n in case[4]])
def test_float_flooding_decode_matches_jax(code, decoder):
    jlg, x = _inputs(code)
    iters = CASES[code][2]
    _, ja = jax_factory.make_arithmetic(decoder)
    jout = jax_flooding(jlg, ja, jnp.asarray(x), iters)
    dec = Decoder(code_objects(code, torch_codes), decoder, device="cpu")
    assert dec.schedule == "flooding"
    out = dec.decode_batch(x, max_iterations=iters)
    s = np.asarray(jout["success"])
    differs = np.nonzero((s != out["success"].numpy())
                         | (np.asarray(jout["iterations"]) != out["iterations"].numpy()))[0]
    assert not differs.size, (
        f"{decoder} on {code} (seed {CASES[code][3]}): frame {differs[0]} differs")
    np.testing.assert_array_equal(np.asarray(jout["success"]), out["success"].numpy())
    np.testing.assert_array_equal(np.asarray(jout["iterations"]), out["iterations"].numpy())
    np.testing.assert_array_equal(np.asarray(jout["codeword"]), out["codeword"].numpy())
    if code == "bg2z16":
        assert_same_decode(jout, out)
    else:  # noisy codewords: most frames decode their own codeword
        assert s.sum() >= 100


def test_default_decoder_is_phif64(monkeypatch):
    """``Decoder(code)``, a default ``BerTestParameters`` and ``ber``
    without ``--decoder`` all build the reference's default, ``Phif64``:
    flooding, float64 on every device."""
    dec = Decoder(torch_codes.dvbs2.Code.R1_4short, device="cpu")
    assert dec.implementation == "Phif64" and dec.schedule == "flooding"
    assert isinstance(dec.arithmetic, arithmetic.PhiArithmetic)
    assert dec.arithmetic.storage_dtype == torch.float64
    _, tlg = lifted_graphs("bg2z16")
    h = parity_check("bg2z16", torch_codes)
    assert BerTestParameters(h=h, lifted_graph=tlg).decoder_implementation == "Phif64"
    test = BerTestBuilder(h=h, lifted_graph=tlg, device="cpu").build()
    assert test.schedule == "flooding" and isinstance(test.arithmetic, arithmetic.PhiArithmetic)
    built = []
    real_build = BerTestBuilder.build

    def build(self):
        built.append(real_build(self))
        return types.SimpleNamespace(run=lambda: iter(()))

    monkeypatch.setattr(BerTestBuilder, "build", build)
    cli.main(["ber", "5g:2:16", "--device", "cpu", "--min-ebn0", "1",
              "--max-ebn0", "1", "--step-ebn0", "1"])
    (test,) = built
    assert test.p.decoder_implementation == "Phif64"
    assert isinstance(test.arithmetic, arithmetic.PhiArithmetic)
    assert test.arithmetic.storage_dtype == torch.float64
    # and one Phif64 decode on the CPU: the all-zero word at high SNR
    x = llrs(tlg.n, 8, 0.5, seed=1)
    out = Decoder(code_objects("bg2z16", torch_codes), device="cpu").decode_batch(x, 10)
    assert out["success"].all() and not out["codeword"].any()


@pytest.mark.parametrize("decoder", ["HLPhif32", "Tanhf64", "HLMinstarapproxf64", "Aminstarf32"])
def test_streaming_refuses_float_rules(decoder):
    """``resident=False`` of a float name (the streaming sweep or phases,
    on the CPU their plain versions, under staged compaction, f64 state
    for the f64 names) equals the resident decode of the same name. (The
    name dates from when the streaming kernels carried min-sum only and
    this raised.)"""
    _, tlg = lifted_graphs("bg2z16")
    _, ta = make_arithmetic(decoder)
    decode = (lifted_layered.lifted_layered_decode if decoder.startswith("HL")
              else lifted_flooding.lifted_flooding_decode)
    # the layered schedule converges faster: more noise for a mix
    x = torch.from_numpy(llrs(tlg.n, 48, 1.6 if decoder.startswith("HL") else 1.3, seed=1))
    stream = decode(tlg, ta, x, 8, resident=False)
    resident = decode(tlg, ta, x, 8)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(stream[key], resident[key]), key
    assert 0 < int(stream["success"].sum()) < 48


def _one_wide_check(degree):
    """A graph of Z = 1 whose one check has ``degree`` variables, each of
    degree 1 but the first, which a second check of degree 2 shares."""
    h = SparseMatrix(2, degree)
    h.insert_row(0, range(degree))
    h.insert_row(1, [0, 1])
    return LiftedGraph.from_sparse(h, lambda v: (v, 0), lambda c: (c, 0), 1, degree, 2)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_minstarapprox_refuses_checks_above_32(schedule):
    """MinstarApprox's kernels unroll their O(d^2) fold to the degree bucket
    and take degree 32 at most: a check of 33 raises a ValueError that
    names the cap, on the CPU as on the card; Phi (cap 64) decodes it."""
    prefix = "HL" if schedule == "layered" else ""
    decode = (lifted_layered.lifted_layered_decode if schedule == "layered"
              else lifted_flooding.lifted_flooding_decode)
    x = torch.from_numpy(llrs(33, 4, 0.8, seed=2))
    for prec in ("f32", "f64"):
        _, ta = make_arithmetic(prefix + "Minstarapprox" + prec)
        with pytest.raises(ValueError, match="above 32"):
            decode(_one_wide_check(33), ta, x, 4)
        assert decode(_one_wide_check(32), ta, x[:, :32], 4)["codeword"].shape == (4, 32)
    _, phi = make_arithmetic(prefix + "Phif32")
    assert decode(_one_wide_check(33), phi, x, 4)["codeword"].shape == (4, 33)
