"""The port's simulation layer against the JAX package's on the CPU: the
puncturer and the interleaver (equal, on the reference's fixtures and on
batched inputs), 8PSK (``modulate`` equal; ``demodulate`` within
1e-5 + 1e-6·|LLR|: XLA's and torch's CPU exp and log1p are other
approximations, and XLA flushes subnormals), the complex AWGN channel, the
whole chain before the decoder on the same noise, ``BerTest``'s n and
rate, and decodes of the JAX chain's LLRs, bit for bit."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu.decoder import Decoder as JaxDecoder
from ldpc_toolbox_tpu.mackay_neal import Config as JaxMNConfig
from ldpc_toolbox_tpu.simulation import BerTestBuilder as JaxBerTestBuilder
from ldpc_toolbox_tpu.simulation import Bpsk as JaxBpsk
from ldpc_toolbox_tpu.simulation import Interleaver as JaxInterleaver
from ldpc_toolbox_tpu.simulation import Modulation as JaxModulation
from ldpc_toolbox_tpu.simulation import Psk8 as JaxPsk8
from ldpc_toolbox_tpu.simulation import Puncturer as JaxPuncturer
from ldpc_toolbox_tpu.simulation.puncturing import PuncturingError as JaxPuncturingError
from ldpc_toolbox_tpu.systematic import parity_to_systematic as jax_parity_to_systematic
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.decoder import Decoder
from ldpc_toolbox_torch.mackay_neal import Config as MNConfig
from ldpc_toolbox_torch.simulation import (
    AwgnChannel,
    BerTestBuilder,
    Bpsk,
    Interleaver,
    Modulation,
    Psk8,
    Puncturer,
)
from ldpc_toolbox_torch.simulation.ber import step_generator

# The tests run many small ops on small tensors; one intra-op thread per
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
from ldpc_toolbox_torch.simulation.puncturing import PuncturingError
from ldpc_toolbox_torch.systematic import parity_to_systematic

#: the demap's tolerance: absolute plus relative to the LLR's magnitude
ATOL, RTOL = 1e-5, 1e-6
PATTERNS = ["1,1,1,1,0", "1,1,1,1,1,1,1,1,1,1,0", "1,0", "0,1,1,0,1", "1,1,1"]


def _pattern(s):
    return [c == "1" for c in s.split(",")]


@functools.cache
def mn66():
    """(JAX h, port h): the 66-column MacKay-Neal code of the JAX
    package's 8PSK test (tests/test_simulation.py), each package's own."""
    jh = jax_parity_to_systematic(JaxMNConfig(nrows=30, ncols=66, wr=8, wc=3).run(5))
    th = parity_to_systematic(MNConfig(nrows=30, ncols=66, wr=8, wc=3).run(5))
    assert th.alist() == jh.alist()
    return jh, th


def test_puncturer_fixtures():
    """The reference's fixtures (puncturing.rs:118-129)."""
    p = Puncturer([True, True, False, True, False])
    np.testing.assert_array_equal(p.puncture(torch.arange(10)).numpy(), [0, 1, 2, 3, 6, 7])
    back = p.depuncture(torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]))
    np.testing.assert_array_equal(back.numpy(), [1, 2, 3, 4, 0, 0, 5, 6, 0, 0])
    assert p.rate() == 5 / 3
    p = Puncturer([True, False])
    out = p.puncture(torch.arange(12).reshape(2, 6))
    np.testing.assert_array_equal(out.numpy(), [[0, 1, 2], [6, 7, 8]])
    back = p.depuncture(out.float())
    np.testing.assert_array_equal(back.numpy(), [[0, 1, 2, 0, 0, 0], [6, 7, 8, 0, 0, 0]])


@pytest.mark.parametrize("pattern", PATTERNS)
def test_puncturer_matches_jax(pattern):
    bits = _pattern(pattern)
    L = 6 * len(bits)
    x = np.random.default_rng(len(pattern)).standard_normal((3, 4, L)).astype(np.float32)
    p, jp = Puncturer(bits), JaxPuncturer(bits)
    assert p.rate() == jp.rate()
    tx = p.puncture(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jp.puncture(jnp.asarray(x))), tx.numpy())
    back = p.depuncture(tx)
    np.testing.assert_array_equal(np.asarray(jp.depuncture(jnp.asarray(tx.numpy()))),
                                  back.numpy())
    assert back.dtype == torch.float32 and back.shape == x.shape
    cw = torch.from_numpy((x > 0).astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(jp.puncture(jnp.asarray(cw.numpy()))),
                                  p.puncture(cw).numpy())


def test_puncturing_errors_match_jax():
    p, jp = Puncturer([True, True, False]), JaxPuncturer([True, True, False])
    for fn, jfn, n in ((p.puncture, jp.puncture, 10), (p.depuncture, jp.depuncture, 5)):
        with pytest.raises(JaxPuncturingError) as jerr:
            jfn(jnp.zeros(n))
        with pytest.raises(PuncturingError) as err:
            fn(torch.zeros(n))
        assert str(err.value) == str(jerr.value)
    assert issubclass(PuncturingError, ValueError)


def test_interleaver_fixtures():
    """The reference's fixtures (interleaving.rs:92-124)."""
    out = Interleaver(3, False).interleave(torch.arange(6))
    np.testing.assert_array_equal(out.numpy(), [0, 2, 4, 1, 3, 5])
    out = Interleaver(3, True).interleave(torch.arange(6))
    np.testing.assert_array_equal(out.numpy(), [4, 2, 0, 5, 3, 1])


@pytest.mark.parametrize("columns", [3, -3, 4, -5])
def test_interleaver_matches_jax(columns):
    il = Interleaver(abs(columns), columns < 0)
    jil = JaxInterleaver(abs(columns), columns < 0)
    x = np.random.default_rng(abs(columns)).standard_normal((2, 3, 60)).astype(np.float32)
    y = il.interleave(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jil.interleave(jnp.asarray(x))), y.numpy())
    back = il.deinterleave(y)
    np.testing.assert_array_equal(np.asarray(jil.deinterleave(jnp.asarray(y.numpy()))),
                                  back.numpy())
    np.testing.assert_array_equal(back.numpy(), x)


def test_psk8_modulate_matches_jax():
    m = Psk8()
    a = math.sqrt(0.5)
    x = m.modulate(torch.tensor([1, 1, 0, 0, 0, 0, 1, 0, 1]))
    np.testing.assert_allclose(x.numpy(), [complex(-a, a), complex(a, a), complex(a, -a)],
                               atol=1e-6)
    bits = np.random.default_rng(0).integers(0, 2, (5, 7, 300)).astype(np.uint8)
    sym = m.modulate(torch.from_numpy(bits))
    assert sym.dtype == torch.complex64 and sym.shape == (5, 7, 100)
    np.testing.assert_array_equal(np.asarray(JaxPsk8().modulate(jnp.asarray(bits))),
                                  sym.numpy())


def test_psk8_demodulate_signs():
    a = math.sqrt(0.5)
    llr = Psk8().demodulate(torch.tensor([complex(1, 0), complex(a, a), complex(0, 1)],
                                         dtype=torch.complex64), 1.0)
    # the symbols carry 001, 000, 100
    np.testing.assert_array_equal(np.sign(llr.numpy()), [1, 1, -1, 1, 1, 1, -1, 1, 1])


def _assert_llrs_close(jax_llr, llr):
    jax_llr = np.asarray(jax_llr)
    assert llr.dtype == torch.float32 and llr.shape == jax_llr.shape
    err = np.abs(llr.numpy() - jax_llr)
    bound = ATOL + RTOL * np.abs(jax_llr)
    assert (err <= bound).all(), f"worst {err.max()} at |llr| {np.abs(jax_llr).max()}"


@pytest.mark.parametrize("sigma", [0.3, 0.6, 0.9, 1.2])
def test_psk8_demodulate_matches_jax(sigma):
    rng = np.random.default_rng(int(sigma * 10))
    bits = rng.integers(0, 2, (64, 6000)).astype(np.uint8)
    sym = JaxPsk8().modulate(jnp.asarray(bits))
    noise = rng.standard_normal((2, *sym.shape)).astype(np.float32)
    rx = np.asarray(sym) + sigma * (noise[0] + 1j * noise[1]).astype(np.complex64)
    rx = rx.astype(np.complex64)
    llr = Psk8().demodulate(torch.from_numpy(rx), sigma)
    _assert_llrs_close(JaxPsk8().demodulate(jnp.asarray(rx), sigma), llr)
    # the hard decisions are mostly the sent bits (Gray: a symbol error
    # to a neighbour flips one bit)
    if sigma == 0.3:
        assert ((llr.numpy() < 0) == bits.astype(bool)).mean() > 0.9


def test_complex_awgn():
    """Two real draws from the generator, the real part's first, each of
    standard deviation sigma; zero sigma leaves the symbols as they are."""
    sym = torch.zeros((40, 5000), dtype=torch.complex64)
    rx = AwgnChannel.add_noise(sym, 0.7, step_generator(1, 2, 3, "cpu"))
    assert rx.dtype == torch.complex64 and rx.shape == sym.shape
    for part in (rx.real, rx.imag):
        assert abs(float(part.mean())) < 0.01
        assert abs(float(part.var()) - 0.49) < 0.01
    assert abs(float((rx.real * rx.imag).mean())) < 0.01
    gen = step_generator(1, 2, 3, "cpu")
    re = torch.randn(sym.shape, generator=gen)
    im = torch.randn(sym.shape, generator=gen)
    np.testing.assert_array_equal(rx.numpy(), torch.complex(0.7 * re, 0.7 * im).numpy())
    x = torch.tensor([1 + 1j, -1 - 1j], dtype=torch.complex64)
    np.testing.assert_array_equal(
        AwgnChannel.add_noise(x, 0.0, step_generator(0, 0, 0, "cpu")).numpy(), x.numpy())


#: the chains before the decoder: code, modulation, puncturing pattern,
#: interleaver columns, Eb/N0 (dB)
CHAINS = {
    "mn66-8psk-punctured": ("mn66", "8PSK", "1,1,1,1,1,1,1,1,1,1,0", 3, 3.0),
    "mn66-bpsk-punctured": ("mn66", "BPSK", "1,1,1,1,1,0", None, 2.0),
    "R3_5short-8psk": ("R3_5short", "8PSK", None, -3, 3.75),
}


def _chain_tests(case, **kw):
    """(JAX BerTest, port BerTest) of a chain."""
    code, modulation, pattern, columns, _ = CHAINS[case]
    if code == "mn66":
        jh, th = mn66()
    else:
        jh, th = (getattr(c.dvbs2.Code, code).h() for c in (jax_codes, torch_codes))
    common = dict(puncturing_pattern=_pattern(pattern) if pattern else None,
                  interleaving_columns=columns, **kw)
    jtest = JaxBerTestBuilder(h=jh, modulation=JaxModulation.parse(modulation),
                              **common).build()
    test = BerTestBuilder(h=th, modulation=Modulation.parse(modulation), device="cpu",
                          **common).build()
    return jtest, test


@functools.cache
def jax_chain(case, batch=16):
    """(codewords, noise, sigma, JAX LLRs) of a chain: the JAX test's
    encoder's codewords of random messages, then its puncturer,
    interleaver, modulation, the given noise, demodulation, deinterleaver
    and depuncturer."""
    jtest, _ = _chain_tests(case)
    rng = np.random.default_rng(7)
    msg = rng.integers(0, 2, (batch, jtest.k)).astype(np.uint8)
    cw = np.array(jtest.encoder._encode_batch(jnp.asarray(msg)))
    ebn0 = 10 ** (0.1 * CHAINS[case][4])
    sigma = math.sqrt(0.5 / (jtest.rate * jtest.modulation.BITS_PER_SYMBOL * ebn0))
    mod = jtest.modulation
    tx = jtest.puncturer.puncture(jnp.asarray(cw)) if jtest.puncturer else jnp.asarray(cw)
    tx = jtest.interleaver.interleave(tx) if jtest.interleaver else tx
    sym = mod.modulate(tx)
    noise = rng.standard_normal((2, *sym.shape)).astype(np.float32)
    if mod.COMPLEX:
        rx = sym + sigma * (jnp.asarray(noise[0]) + 1j * jnp.asarray(noise[1]))
    else:
        rx = sym + sigma * jnp.asarray(noise[0])
    llr = mod.demodulate(rx, sigma)
    llr = jtest.interleaver.deinterleave(llr) if jtest.interleaver else llr
    llr = jtest.puncturer.depuncture(llr) if jtest.puncturer else llr
    return cw, noise, sigma, np.array(llr)


@pytest.mark.parametrize("case", list(CHAINS))
def test_chain_matches_jax(case):
    """The port's chain on the same codewords and noise: the sent symbols
    equal, the decoder's LLRs within the demap's tolerance (BPSK equal),
    zero at the punctured bits."""
    jtest, test = _chain_tests(case)
    cw, noise, sigma, jllr = jax_chain(case)
    x = torch.from_numpy(cw)
    tx = test.puncturer.puncture(x) if test.puncturer else x
    tx = test.interleaver.interleave(tx) if test.interleaver else tx
    sym = test.modulation.modulate(tx)
    jtx = jtest.puncturer.puncture(jnp.asarray(cw)) if jtest.puncturer else jnp.asarray(cw)
    jtx = jtest.interleaver.interleave(jtx) if jtest.interleaver else jtx
    np.testing.assert_array_equal(np.asarray(jtest.modulation.modulate(jtx)), sym.numpy())
    if test.modulation.COMPLEX:
        rx = sym + torch.complex(sigma * torch.from_numpy(noise[0]),
                                 sigma * torch.from_numpy(noise[1]))
    else:
        rx = sym + sigma * torch.from_numpy(noise[0])
    llr = test.modulation.demodulate(rx, sigma)
    llr = test.interleaver.deinterleave(llr) if test.interleaver else llr
    llr = test.puncturer.depuncture(llr) if test.puncturer else llr
    if test.modulation.COMPLEX:
        _assert_llrs_close(jllr, llr)
    else:
        np.testing.assert_array_equal(jllr, llr.numpy())
    assert llr.shape == cw.shape
    if test.puncturer:
        bs = cw.shape[1] // len(test.puncturer.pattern)
        for k, kept in enumerate(test.puncturer.pattern):
            assert (llr[:, k * bs:(k + 1) * bs] == 0).all().item() != kept
    # the hard decisions of the sent bits mostly agree with the codewords
    sent = (llr != 0).numpy()
    assert ((llr.numpy() < 0) == cw.astype(bool))[sent].mean() > 0.8


@pytest.mark.parametrize("case", list(CHAINS))
def test_n_rate_and_sigma_match_jax(case):
    jtest, test = _chain_tests(case)
    assert (test.k, test.n, test.n_cw) == (jtest.k, jtest.n, jtest.n_cw)
    assert test.rate == jtest.rate
    assert test.modulation.BITS_PER_SYMBOL == jtest.modulation.BITS_PER_SYMBOL
    for ebn0 in (0.0, 2.5, 4.2):
        # the JAX sweep's formula (simulation/ber.py run), in its order
        e = jtest.rate * jtest.modulation.BITS_PER_SYMBOL * 10.0 ** (0.1 * ebn0)
        assert test.noise_sigma(ebn0) == float(np.sqrt(0.5 / e))


def test_config3_n_and_rate():
    """AR4JA r=4/5 k=4096 with the last of its 11 blocks punctured
    (tools/run_results.sh config 3): 5632 columns, 5120 sent, rate 4/5."""
    jh, th = (c.ccsds.AR4JACode(c.ccsds.AR4JARate.R4_5, c.ccsds.AR4JAInfoSize.K4096).h()
              for c in (jax_codes, torch_codes))
    pattern = _pattern("1,1,1,1,1,1,1,1,1,1,0")
    test = BerTestBuilder(h=th, puncturing_pattern=pattern, device="cpu").build()
    jtest = JaxBerTestBuilder(h=jh, puncturing_pattern=pattern).build()
    assert (test.n_cw, test.n, test.rate) == (jtest.n_cw, jtest.n, jtest.rate) == (
        5632, 5120, 0.8)


@pytest.mark.parametrize("case, name", [
    ("mn66-8psk-punctured", "Minsumf32"), ("mn66-8psk-punctured", "Minstarapproxi8"),
    ("R3_5short-8psk", "HLMinsumbf16"), ("R3_5short-8psk", "HLMinstarapproxi8"),
])
def test_decodes_of_jax_chain_llrs(case, name):
    """The JAX chain's LLRs (8PSK, depunctured zeros) through the port's
    decoder and the JAX package's, bit for bit: the generic flooding decode
    of the MacKay-Neal code's H, the lifted layered decode of DVB-S2
    R3_5short (on the CPU the JAX package's lifted flooding decode sums
    the variable rule in another order, tests/test_torch_flooding.py)."""
    cw, _, _, llr = jax_chain(case)
    if case.startswith("mn66"):
        jh, th = mn66()
        jdec, dec = JaxDecoder(jh, name), Decoder(th, name, device="cpu")
    else:
        jdec = JaxDecoder(jax_codes.dvbs2.Code.R3_5short, name)
        dec = Decoder(torch_codes.dvbs2.Code.R3_5short, name, device="cpu")
    jout = jdec.decode_batch(jnp.asarray(llr), 10)
    out = dec.decode_batch(torch.from_numpy(llr), 10)
    for key in ("success", "iterations", "codeword"):
        np.testing.assert_array_equal(np.asarray(jout[key]), out[key].numpy(), key)
    assert 0 < int(out["success"].sum()) <= len(cw)


@pytest.mark.parametrize("code", ["R1_4short", "mn66"], ids=["staircase", "dense"])
def test_encoder_encode_matches_jax(code):
    """``Encoder.encode``, one message on the host, equals the JAX
    package's and the port's batch encode."""
    from ldpc_toolbox_tpu.encoder import Encoder as JaxEncoder
    from ldpc_toolbox_torch.encoder import Encoder

    if code == "mn66":
        jh, th = mn66()
    else:
        jh, th = (getattr(c.dvbs2.Code, code).h() for c in (jax_codes, torch_codes))
    enc, jenc = Encoder(th, device="cpu"), JaxEncoder(jh)
    assert enc.staircase == (code != "mn66")
    msgs = np.random.default_rng(9).integers(0, 2, (3, enc.k)).astype(np.uint8)
    batch = enc.encode_batch(torch.from_numpy(msgs)).numpy()
    for msg, cw in zip(msgs, batch):
        one = enc.encode(msg)
        assert one.dtype == np.uint8
        np.testing.assert_array_equal(one, jenc.encode(msg))
        np.testing.assert_array_equal(one, cw)
