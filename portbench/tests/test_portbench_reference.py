"""The plain reference against the port's CPU path on short DVB-S2
frames: the same H, codewords, LLRs, decoder answers and counters."""

import json

import numpy as np
import pytest
import torch

from conftest import HERE, SMALL
from ldpc_toolbox_torch.codes.dvbs2 import Code
from ldpc_toolbox_torch.decoder import Decoder
from ldpc_toolbox_torch.simulation.ber import _frame_counters, step_generator
from portbench import harness
from portbench.reference import dvbs2
from portbench.reference.step import ReferenceStep
from portbench.reference.step import step_generator as reference_generator


@pytest.mark.parametrize("spec, name", [
    ("dvbs2:1/2", "R1_2"), ("dvbs2:3/5", "R3_5"),
    ("dvbs2:1/2:short", "R1_2short"), ("dvbs2:3/5:short", "R3_5short"),
])
def test_h_is_the_ports(spec, name):
    rows, cols = dvbs2.code(spec).edges()
    port = sorted(Code[name].h().iter_all())
    assert list(zip(rows.tolist(), cols.tolist())) == port


def _config(base, **change):
    config = json.loads((HERE / "configs" / f"{base}.json").read_text())
    config.update(change)
    return config


@pytest.mark.parametrize("name, base, code", SMALL)
@pytest.mark.parametrize("ebn0", [1.0, 6.0])
def test_step_is_the_ports(name, base, code, ebn0):
    """One ``ber`` step of the port and of the reference from the same
    generator: messages, codewords, LLRs, the decode and the counters."""
    config = _config(base, code=code, batch_size=8, max_iter=5)
    test = harness.build_test(config, "cpu")
    ref = ReferenceStep(config, "cpu")
    sigma = test.noise_sigma(ebn0)
    assert sigma == ref.sigma(ebn0)
    gen = step_generator(2**31 + 5, 0, 3, "cpu")
    msg = torch.randint(0, 2, (8, test.k), generator=gen, dtype=torch.uint8)
    cw = test.encode(msg)
    llr = test.channel_llrs(cw, sigma, gen)
    r_msg, r_cw, r_llr = ref.inputs(reference_generator(2**31 + 5, 0, 3, "cpu"), ebn0)
    assert torch.equal(msg, r_msg)
    assert torch.equal(cw, r_cw)
    assert torch.equal(llr, r_llr)
    out = test.decode(test.graph, test.arithmetic, llr, config["max_iter"])
    r_out = ref.decode(llr)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], r_out[key]), key
    assert _frame_counters(msg, out, 0) == ref.counters(msg, r_out)


@pytest.mark.parametrize("decoder, schedule", [("HLMinsumbf16", "layered"),
                                               ("Minsumbf16", "flooding")])
def test_decoder_is_the_ports_where_frames_converge(decoder, schedule):
    """Noisy LLRs around the all-zero codeword of R1_2short at a spread
    of SNRs, so that frames stop at many different iterations."""
    config = _config("dvbs2-1_2-bpsk-hlminsumbf16", code="dvbs2:1/2:short", max_iter=12)
    config["reference"] = dict(config["reference"], schedule=schedule)
    ref = ReferenceStep(config, "cpu")
    rng = np.random.default_rng(7)
    mean = np.linspace(1.8, 3.5, 16, dtype=np.float32)[:, None]  # 2 / sigma^2
    noise = rng.standard_normal((16, 16200), dtype=np.float32)
    llr = torch.from_numpy(mean + np.sqrt(2 * mean) * noise)
    out = Decoder(Code.R1_2short, decoder, device="cpu").decode_batch(llr, 12)
    r_out = ref.decode(llr)
    assert len(set(out["iterations"].tolist())) > 3
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], r_out[key]), key
