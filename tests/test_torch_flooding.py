"""The port's flooding decode on the CPU against the JAX package: both of
the port's forms against the JAX resident kernels (``fused=True,
resident=True``, interpret mode) bit for bit on all frames; the
``Decoder`` against the JAX ``Decoder`` (its plane-gather path) to the
JAX package's own bar; ``BerTest.step`` against the JAX step formulas on
the same draws; and the entry points' default device."""

import dataclasses
import functools
import inspect
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu.decoder import Decoder as JaxDecoder
from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_flooding import (
    lifted_flooding_decode as jax_lifted_flooding_decode,
)
from ldpc_toolbox_tpu.encoder import Encoder as JaxEncoder
from ldpc_toolbox_tpu.simulation.modulation import Bpsk as JaxBpsk
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.decoder import Decoder
from ldpc_toolbox_torch.decoder import lifted_flooding
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.encoder import Encoder
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.simulation.ber import BerTestParameters, step_generator

from torch_parity import (
    FLOODING_CASES,
    FLOODING_DECODERS,
    assert_same_decode,
    code_objects,
    jax_flooding_case,
    lifted_graphs,
    parity_check,
)


REPO = pathlib.Path(__file__).resolve().parent.parent


@functools.cache
def _case(code, decoder):
    return jax_flooding_case(code, decoder, resident=True)


@pytest.mark.parametrize("resident", [False, True], ids=["streaming", "resident"])
@pytest.mark.parametrize("decoder", FLOODING_DECODERS)
@pytest.mark.parametrize("code", list(FLOODING_CASES))
def test_decode_matches_jax_resident(code, decoder, resident):
    tlg, x, jout = _case(code, decoder)
    _, ta = make_arithmetic(decoder)
    tout = lifted_flooding.lifted_flooding_decode(
        tlg, ta, torch.from_numpy(x), FLOODING_CASES[code][2], resident=resident
    )
    assert_same_decode(jout, tout)


@pytest.mark.parametrize("decoder", ["Minsumf32", "Normminsumf32"])
@pytest.mark.parametrize("code", list(FLOODING_CASES))
def test_decoder_matches_jax_decoder(code, decoder):
    """The JAX ``Decoder`` on the CPU runs its plane-gather path, which sums
    the variable rule in another order than the kernels: equal success and
    iterations, and equal codewords of the converged frames (the bar of the
    JAX package's tests/test_lifted.py, which holds it for f32 storage; for
    the bf16 names that path keeps the channel LLRs in f32 where the kernels
    cast them to bf16, so it is another decoder there)."""
    _, x, _ = _case(code, "Minsumf32")
    iters = FLOODING_CASES[code][2]
    jout = JaxDecoder(code_objects(code, jax_codes), decoder).decode_batch(
        x, max_iterations=iters
    )
    dec = Decoder(code_objects(code, torch_codes), decoder, device="cpu")
    assert dec.schedule == "flooding"
    tout = dec.decode_batch(x, max_iterations=iters)
    s = np.asarray(jout["success"])
    np.testing.assert_array_equal(s, tout["success"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jout["iterations"]), tout["iterations"].numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jout["codeword"])[s], tout["codeword"].numpy()[s]
    )
    assert 0 < s.sum() < s.size


def test_decoder_single_frame_and_refusals():
    _, x, jout = _case("R1_4short", "Minsumbf16")
    dec = Decoder(torch_codes.dvbs2.Code.R1_4short, "Minsumbf16", device="cpu")
    for i in (0, 1, 2):
        one = dec.decode(x[i], max_iterations=FLOODING_CASES["R1_4short"][2])
        assert one.success == bool(jout["success"][i])
        assert one.iterations == int(jout["iterations"][i])
        assert (one.codeword == np.asarray(jout["codeword"][i])).all()
    # every name builds; a parity-check matrix takes the generic path
    assert Decoder(torch_codes.dvbs2.Code.R1_4short, "Phif64", device="cpu").schedule == "flooding"
    generic = Decoder(torch_codes.dvbs2.Code.R1_4short.h(), "Phif64", device="cpu")
    assert generic.lifted is None and generic.schedule == "flooding"


def test_ber_step_matches_jax():
    """BerTest.step with Minsumbf16 (flooding) draws the message, then the
    noise, from its generator; the same draws through the JAX encoder,
    channel and fused flooding decode give the same nine counters."""
    jlg, tlg = lifted_graphs("R1_4short")
    code = torch_codes.dvbs2.Code.R1_4short
    batch, iters, sigma = 32, 6, 0.95
    test = BerTestBuilder(
        h=code.h(), lifted_graph=tlg, decoder_implementation="Minsumbf16",
        max_iterations=iters, batch_size=batch, bch_max_errors=1,
        device="cpu",
    ).build()
    counters = test.step(step_generator(0, 0, 0, "cpu"), sigma)

    gen = step_generator(0, 0, 0, "cpu")
    msg = torch.randint(0, 2, (batch, code.k), generator=gen, dtype=torch.uint8)
    noise = torch.randn((batch, code.n), generator=gen).numpy()
    jmod = JaxBpsk()
    cw = JaxEncoder(parity_check("R1_4short", jax_codes))._encode_batch(
        jnp.asarray(msg.numpy())
    )
    llr = jmod.demodulate(jmod.modulate(cw) + sigma * jnp.asarray(noise), sigma)
    _, ja = jax_factory.make_arithmetic("Minsumbf16")
    out = jax_lifted_flooding_decode(
        jlg, ja, llr, iters, fused=True, resident=True
    )
    m = msg.numpy()
    errbits = (np.asarray(out["codeword"])[:, : code.k] != m).sum(axis=1)
    frame_err = errbits > 0
    it = np.asarray(out["iterations"])
    bch_err = errbits > 1
    expected = {
        "num_frames": batch,
        "bit_errors": errbits.sum(),
        "frame_errors": frame_err.sum(),
        "false_decodes": (frame_err & np.asarray(out["success"])).sum(),
        "total_iterations": it.sum(),
        "correct_iterations": np.where(frame_err, 0, it).sum(),
        "bch_bit_errors": np.where(bch_err, errbits, 0).sum(),
        "bch_frame_errors": bch_err.sum(),
        "bch_correct_iterations": np.where(bch_err, 0, it).sum(),
    }
    assert counters == {k: int(v) for k, v in expected.items()}
    assert 0 < counters["frame_errors"] < batch
    assert 0 < counters["bch_frame_errors"] < counters["frame_errors"]


def test_entry_points_default_to_the_card():
    """Decoder, BerTestParameters (so BerTestBuilder) and Encoder run on
    "cuda" unless the caller asks for the CPU."""
    for cls in (Decoder, Encoder):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    fields = {f.name: f for f in dataclasses.fields(BerTestBuilder)}
    assert fields["device"].default == "cuda"
    assert BerTestBuilder is not BerTestParameters
    assert issubclass(BerTestBuilder, BerTestParameters)
    # the Decoder moves nothing at construction, so it can be built here
    dec = Decoder(torch_codes.dvbs2.Code.R1_4short, "Minsumbf16")
    assert dec.device.type == "cuda"


def test_cli_ber_floods(tmp_path):
    """``ber --decoder Minsumbf16`` runs the flooding path end to end."""
    out = tmp_path / "ber.txt"
    cmd = [
        sys.executable, "-m", "ldpc_toolbox_torch", "ber", "dvbs2:1/4:short",
        "--decoder", "Minsumbf16", "--device", "cpu", "--min-ebn0", "0.0",
        "--max-ebn0", "0.0", "--step-ebn0", "1.0", "--max-iter", "6",
        "--frame-errors", "4", "--batch-size", "16", "--output-file", str(out),
    ]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    lines = out.read_text().splitlines()
    assert len(lines) == 3 and lines[2].strip().startswith("0.00")
    assert int(lines[2].split("|")[1]) >= 16  # frames
