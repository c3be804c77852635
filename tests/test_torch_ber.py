"""The port's BER chain against the JAX package's building blocks on the
same messages and noise: encoder, BPSK + AWGN + demodulation, and the
step's nine counters; and the ``ber`` command line end to end on the
CPU."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder import lifted_layered as jax_layered
from ldpc_toolbox_tpu.encoder import Encoder as JaxEncoder
from ldpc_toolbox_tpu.simulation.modulation import Bpsk as JaxBpsk
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.encoder import Encoder
from ldpc_toolbox_torch.simulation import AwgnChannel, Bpsk, BerTestBuilder
from ldpc_toolbox_torch.simulation.ber import step_generator

from torch_parity import lifted_graphs, parity_check

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "code, staircase",
    [("R1_4short", True), ("bg2z16", False)],
    ids=["staircase", "dense"],
)
def test_encoder_matches_jax(code, staircase):
    h = parity_check(code, torch_codes)
    msg = np.random.default_rng(0).integers(0, 2, (16, h.num_cols - h.num_rows))
    msg = msg.astype(np.uint8)
    enc = Encoder(h, device="cpu")
    assert enc.staircase == staircase
    cw = enc.encode_batch(torch.from_numpy(msg))
    jenc = JaxEncoder(parity_check(code, jax_codes))
    np.testing.assert_array_equal(
        np.asarray(jenc._encode_batch(jnp.asarray(msg))), cw.numpy()
    )


def test_bpsk_awgn_demodulate_matches_jax():
    bits = np.random.default_rng(1).integers(0, 2, (8, 300)).astype(np.uint8)
    sigma = 0.83
    gen = step_generator(3, 1, 2, "cpu")
    noise = torch.randn(bits.shape, generator=step_generator(3, 1, 2, "cpu"))
    mod = Bpsk()
    rx = AwgnChannel.add_noise(mod.modulate(torch.from_numpy(bits)), sigma, gen)
    llr = mod.demodulate(rx, sigma)
    jmod = JaxBpsk()
    jrx = jmod.modulate(jnp.asarray(bits)) + sigma * jnp.asarray(noise.numpy())
    jllr = jmod.demodulate(jrx, sigma)
    assert llr.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jllr), llr.numpy())


def test_step_counters_match_jax():
    """BerTest.step draws the message, then the noise, from its generator;
    the same draws through the JAX encoder, channel and jnp decode give
    the same nine counters (the JAX step's formulas)."""
    jlg, tlg = lifted_graphs("R1_4short")
    code = torch_codes.dvbs2.Code.R1_4short
    test = BerTestBuilder(
        h=code.h(), lifted_graph=tlg, decoder_implementation="HLMinsumbf16",
        max_iterations=8, batch_size=32, bch_max_errors=1, device="cpu",
    ).build()
    sigma = 1.25
    counters = test.step(step_generator(0, 0, 0, "cpu"), sigma)

    gen = step_generator(0, 0, 0, "cpu")
    msg = torch.randint(0, 2, (32, code.k), generator=gen, dtype=torch.uint8)
    noise = torch.randn((32, code.n), generator=gen).numpy()
    jmod = JaxBpsk()
    cw = JaxEncoder(parity_check("R1_4short", jax_codes))._encode_batch(
        jnp.asarray(msg.numpy())
    )
    llr = jmod.demodulate(jmod.modulate(cw) + sigma * jnp.asarray(noise), sigma)
    _, ja = jax_factory.make_arithmetic("Minsumbf16")
    out = jax_layered.lifted_layered_decode(jlg, ja, llr, 8)
    m = msg.numpy()
    errbits = (np.asarray(out["codeword"])[:, : code.k] != m).sum(axis=1)
    frame_err = errbits > 0
    iters = np.asarray(out["iterations"])
    bch_err = errbits > 1
    expected = {
        "num_frames": 32,
        "bit_errors": errbits.sum(),
        "frame_errors": frame_err.sum(),
        "false_decodes": (frame_err & np.asarray(out["success"])).sum(),
        "total_iterations": iters.sum(),
        "correct_iterations": np.where(frame_err, 0, iters).sum(),
        "bch_bit_errors": np.where(bch_err, errbits, 0).sum(),
        "bch_frame_errors": bch_err.sum(),
        "bch_correct_iterations": np.where(bch_err, 0, iters).sum(),
    }
    assert counters == {k: int(v) for k, v in expected.items()}
    assert 0 < counters["frame_errors"] < 32
    assert 0 < counters["bch_frame_errors"] < counters["frame_errors"]


def test_cli_ber_writes_output_file(tmp_path):
    out = tmp_path / "ber.txt"
    cmd = [
        sys.executable, "-m", "ldpc_toolbox_torch", "ber", "dvbs2:1/4:short",
        "--device", "cpu", "--min-ebn0", "-1.0", "--max-ebn0", "0.0",
        "--step-ebn0", "1.0", "--max-iter", "6", "--frame-errors", "4",
        "--batch-size", "16", "--output-file", str(out),
    ]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert "Eb/N0" in proc.stdout
    lines = out.read_text().splitlines()
    assert len(lines) == 4  # 2 header lines + 2 Eb/N0 points
    assert lines[2].strip().startswith("-1.00")
    assert lines[3].strip().startswith("0.00")
    assert len(lines[2].split("|")) == 11
