"""The port's i8 arithmetic, kernel rules and layered decodes against the
JAX package's, bit for bit (tolerance 0: integer arithmetic).

The JAX side runs eagerly (arithmetic, rules) or through its jnp layered
path (``fused=False``), never in Pallas interpret mode; JAX's own tests
hold its i8 Pallas kernels equal to that path (tests/test_lifted_layered.py
test_fused_layered_matches_jnp). The flooding decodes are in
test_torch_i8_flooding.py, the streaming path (``resident=False``) in
test_torch_streaming_i8.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import arithmetic as jax_arithmetic
from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode as jax_layered
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.codes.nr5g import BaseGraph
from ldpc_toolbox_torch.decoder import Decoder, arithmetic
from ldpc_toolbox_torch.decoder import lifted_flooding, lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops import fused_bp2

from torch_parity import (
    I8_NAMES,
    assert_same_decode,
    code_objects,
    lifted_graphs,
    llrs,
    strong_llrs,
)

HL_I8 = ["HLMinstarapproxi8", "HLMinstarapproxi8PartialHardLimit", "HLAminstari8",
         "HLAminstari8PartialHardLimit"]


def test_correction_table_and_thresholds_match_jax():
    """The port's own copy of the table and its thresholds; the kernel
    rule's select tree and the arithmetic's compare sum give the table at
    every t in 0..255 (0 beyond 127)."""
    table = arithmetic.i8_correction_table()
    np.testing.assert_array_equal(table, jax_arithmetic.i8_correction_table())
    assert table.dtype == np.int32
    assert fused_bp2._i8_thresholds() == jax_fused_bp2._i8_thresholds()
    expect = np.concatenate([table, np.zeros(128, np.int32)])
    t = torch.arange(256, dtype=torch.int32)
    rule = fused_bp2.rule_for(make_arithmetic("Minstarapproxi8")[1])
    np.testing.assert_array_equal(rule._tab(t).numpy(), expect)
    _, arith = make_arithmetic("Aminstari8")
    np.testing.assert_array_equal(arith._lookup(t).numpy(), expect)


#: the word arithmetic of csrc/i8.cuh, mirrored on int64 tensors that hold
#: its 32-bit words (a byte a frame): the same bit operations, in the same
#: order, so that a wrong carry, shift or mask shows here on the CPU
_M32, _ONES, _K127, _HIGHS = 0xFFFFFFFF, 0x01010101, 0x7F7F7F7F, 0x80808080


def _high_mask(w):
    """high_mask (PRMT's sign replication): 0xff in each byte whose bit 7
    is set."""
    return sum((((w >> (8 * i + 7)) & 1) * 0xFF) << (8 * i) for i in range(4))


def _steps_of(t, steps):
    """Steps<T...>::of: the table as the count of a thermometer code whose
    indicators are bit 7 of 0x80 + T - t, bit b of the count the parity of
    the indicators m * 2^b - 1 (m odd, each bit's word from the one
    above)."""
    y = [((0x80 + s) * _ONES - t) & _M32 for s in steps]
    total, x = torch.zeros_like(t), torch.zeros_like(t)
    for b in range(len(y).bit_length() - 1, -1, -1):
        for m in range(1, (len(y) >> b) + 1, 2):
            x = x ^ y[(m << b) - 1]
        total = total + ((x & _HIGHS) >> (7 - b))
    return total


def _tab4(t):
    return _steps_of(t, fused_bp2._i8_thresholds())


def _sat_sub4(a, b):
    r = (a + _HIGHS - b) & _M32
    return r & _high_mask(r) & _K127


def _min_diff4(a, b):
    ge = _high_mask((a + _HIGHS - b) & _M32)
    mn = (b & ge) | (a & ~ge & _M32)
    return mn, ((a ^ b ^ mn) - mn) & _M32


def _minstar_approx4(a, b):
    mn, diff = _min_diff4(a, b)
    return _sat_sub4(mn, _tab4(diff))


def _minstar_full4(a, b):
    mn, diff = _min_diff4(a, b)
    s = (a + b) & _M32
    return _sat_sub4((mn + _tab4((s | _high_mask(s)) & _K127)) & _M32, _tab4(diff))


def _phl4(m):
    return (m | _high_mask((m + 28 * _ONES) & _M32)) & _K127


_WORD_STEPS = {
    "tab4": lambda a, b: _tab4(a),
    "minstar_approx4": _minstar_approx4,
    "minstar_full4": _minstar_full4,
    "phl4": lambda a, b: _phl4(a),
}


def _all_pairs_as_words():
    """Every (a, b) in [0, 127]^2, four frames a word, each frame's byte
    through its own permutation of the pairs: (a words, b words, the
    pairs' a and b, the permutations)."""
    a = torch.arange(128, dtype=torch.int64).repeat_interleave(128)
    b = torch.arange(128, dtype=torch.int64).repeat(128)
    g = torch.Generator().manual_seed(0)
    perms = [torch.randperm(a.numel(), generator=g) for _ in range(fused_bp2.BT)]
    wa = sum(a[p] << 8 * f for f, p in enumerate(perms))
    wb = sum(b[p] << 8 * f for f, p in enumerate(perms))
    return wa, wb, a, b, perms


@pytest.mark.parametrize("step", fused_bp2.I8_STEPS)
def test_word_steps_match_the_rules(step):
    """The i8 rules' word steps of ``csrc/i8.cuh`` (the correction table as
    a thermometer count read from the kernels' steps, both families' folds,
    the partial hard limit), mirrored bit for bit, against the plain rules
    on every byte pair in [0, 127]^2 (the table against
    ``_i8_thresholds()`` and the arithmetic's table too), and against
    ``i8_steps``' plain version."""
    wa, wb, a, b, perms = _all_pairs_as_words()
    out = _WORD_STEPS[step](wa, wb)
    assert int(out.max()) <= _M32 and int(out.min()) >= 0
    plain = fused_bp2.i8_steps(wa.to(torch.int32), wb.to(torch.int32))
    assert torch.equal(plain[fused_bp2.I8_STEPS.index(step)].to(torch.int64), out)
    approx, full = fused_bp2.MinstarApproxI8Rule(), fused_bp2.AminstarI8Rule()
    rules = {"tab4": lambda x, y: approx._tab(x), "minstar_approx4": approx._fold,
             "minstar_full4": full._minstar_full, "phl4": lambda x, y: fused_bp2._phl(x)}
    table = torch.from_numpy(arithmetic.i8_correction_table()).to(torch.int64)
    for f, p in enumerate(perms):
        got = (out >> 8 * f) & 0xFF
        x, y = a[p].to(torch.int32), b[p].to(torch.int32)
        assert torch.equal(got, rules[step](x, y).to(torch.int64)), f
        if step == "tab4":
            assert torch.equal(got, table[a[p]])


def test_word_signs_and_magnitudes():
    """I8Check's set and out (``csrc/i8.cuh``) on every input in [-127,
    127]: |x| as x ^ 0xff + 1 in the negative bytes, bit 7 as the sign;
    -m as (0x80 - m) ^ 0x80 for m in [0, 127], 0 for 0."""
    x = torch.arange(-127, 128, dtype=torch.int64)
    w = sum(x.roll(f) % 256 << 8 * f for f in range(fused_bp2.BT))
    s = w & _HIGHS
    mag = ((w ^ _high_mask(w)) + (s >> 7)) & _M32
    for f in range(fused_bp2.BT):
        assert torch.equal((mag >> 8 * f) & 0xFF, x.roll(f).abs())
        assert torch.equal((s >> 8 * f + 7) & 1, (x.roll(f) < 0).to(torch.int64))
    m = torch.arange(128, dtype=torch.int64)
    om = sum(m.roll(f) << 8 * f for f in range(fused_bp2.BT))
    neg = ((_HIGHS - om) ^ _HIGHS) & _M32
    for f in range(fused_bp2.BT):
        assert torch.equal((neg >> 8 * f) & 0xFF, -m.roll(f) % 256)


def test_quantize_matches_jax():
    """The C=8 quantizer on its edges: every half-way point k/16, values
    just above and under them (0.49999997 rounds up in f32 through
    |x| + 0.5, as in the JAX package), the saturation at +-127/8, +-100."""
    halves = np.arange(-2100, 2101, dtype=np.float32) / 16
    around = np.concatenate([
        np.nextafter(halves, np.float32(np.inf)), np.nextafter(halves, np.float32(-np.inf)),
    ])
    special = np.array(
        [0.49999997 / 8, -0.49999997 / 8, 0.0, -0.0, 127 / 8, -127 / 8, 15.8, -15.8,
         100.0, -100.0, 1e-30, -1e-30, 3e38, -3e38], np.float32,
    )
    x = np.concatenate([halves, around, special]).astype(np.float32)
    # no subnormals: XLA on the CPU flushes them to zero, torch does not
    x = x[(np.abs(x) >= np.finfo(np.float32).tiny) | (x == 0)]
    for name in ("Minstarapproxi8", "Aminstari8JonesPartialHardLimitDeg1Clip"):
        _, ja = jax_factory.make_arithmetic(name)
        _, ta = make_arithmetic(name)
        q = ta.quantize(torch.from_numpy(x))
        assert q.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(ja.quantize(jnp.asarray(x))), q.numpy())
    assert int(ta.quantize(torch.tensor([0.49999997 / 8]))[0]) == 1


@functools.cache
def _blocks():
    """int8-range check inputs: unmasked (rows, d, batch) blocks at several
    degrees, and one d=20 block whose masks leave 1 to 20 valid slots."""
    rng = np.random.default_rng(11)

    def values(shape):
        v = rng.integers(-127, 128, shape)
        special = rng.choice([0, 127, -127, 100, -100, 99, 1, -1], shape)
        return np.where(rng.random(shape) < 0.3, special, v).astype(np.int32)

    plain = {d: values((5, d, 48)) for d in (1, 2, 3, 7, 20)}
    mask = np.zeros((20, 20), bool)
    for r in range(20):
        mask[r, rng.permutation(20)[: r + 1]] = True
    return plain, (values((20, 20, 48)), mask)


@pytest.mark.parametrize("name", I8_NAMES)
def test_check_messages_and_var_update_match_jax(name):
    """Both families, all eight variants, with and without a mask, at
    degrees 1 to 20."""
    _, ja = jax_factory.make_arithmetic(name)
    _, ta = make_arithmetic(name)
    plain, (xm, mask) = _blocks()
    rng = np.random.default_rng(12)
    cases = [(x, None) for x in plain.values()] + [(xm, mask)]
    for x, m in cases:
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        out = ta.check_messages(torch.from_numpy(x), tm)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(
            np.asarray(ja.check_messages(jnp.asarray(x), jm)), out.numpy()
        )
        q = rng.integers(-127, 128, (x.shape[0], x.shape[2])).astype(np.int32)
        jv = ja.var_update(jnp.asarray(q), jnp.asarray(x), jm)
        tv = ta.var_update(torch.from_numpy(q), torch.from_numpy(x), tm)
        for a, b in zip(jv, tv):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", I8_NAMES)
def test_rules_match_jax(name):
    """``MinstarApproxI8Rule`` and ``AminstarI8Rule``: ``check`` and ``var``
    on planes, at degrees 1 to 19, and the layered extrinsic."""
    jrule = jax_fused_bp2.rule_for(jax_factory.make_arithmetic(name)[1])
    trule = fused_bp2.rule_for(make_arithmetic(name)[1])
    assert type(trule).__name__ == type(jrule).__name__
    assert (trule.jones, trule.hard_limit, trule.deg1_clip) == (
        jrule.jones, jrule.hard_limit, jrule.deg1_clip)
    assert trule.big == jrule.big == 127 and fused_bp2.is_i8(trule)
    assert (trule.storage_dtype, trule.compute_dtype) == (torch.int8, torch.int32)
    plain, _ = _blocks()
    for d in (1, 2, 3, 7, 19):
        planes = np.concatenate([plain[20][:, :d].transpose(1, 0, 2)] * 2, axis=1)
        jout = jrule.check([jnp.asarray(p) for p in planes])
        tout = trule.check(torch.from_numpy(planes))
        for t in range(d):
            np.testing.assert_array_equal(np.asarray(jout[t]), tout[t].numpy())
        q = planes[0] * 3 // 2  # beyond +-127 too, as a posterior total
        jv, jt = jrule.var(jnp.asarray(q), [jnp.asarray(p) for p in planes], d)
        tv, tt = trule.var(torch.from_numpy(q), list(torch.from_numpy(planes)), d)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        for a, b in zip(jv, tv):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    qv = torch.from_numpy((plain[7][:, 0] * 5).astype(np.int16))
    rold = torch.from_numpy(plain[7][:, 1])
    np.testing.assert_array_equal(
        np.asarray(jrule.layered_x(jnp.asarray(qv.numpy()).astype(jnp.int32),
                                   jnp.asarray(rold.numpy()))),
        trule.layered_x(qv, rold).numpy(),
    )


def test_i8_arithmetic_dtypes_and_variants():
    for name in I8_NAMES:
        _, ja = jax_factory.make_arithmetic(name)
        _, ta = make_arithmetic(name)
        assert type(ta).__name__ == type(ja).__name__ and ta.is_int8
        for prop in ("storage_dtype", "compute_dtype", "var_llr_storage_dtype"):
            assert str(getattr(ta, prop)).split(".")[-1] == jnp.dtype(
                getattr(ja, prop)).name, prop
        assert (ta.jones, ta.hard_limit, ta.deg1_clip) == (
            ja.jones, ja.hard_limit, ja.deg1_clip)


#: layered cases: code -> (batch, sigma, iterations), a convergence mix each;
#: the 5G BG2 z=16 batch holds 64 large-magnitude frames besides
LAYERED_CASES = {"bg2z16": (136, 1.45, 8), "R1_4short": (64, 1.05, 6),
                 "ccsds-c2": (48, 0.5, 6)}
#: the names each code decodes: all four HL i8 names on 5G BG2 z=16, both
#: families on the others
LAYERED_NAMES = {"bg2z16": HL_I8, "R1_4short": ["HLMinstarapproxi8", "HLAminstari8"],
                 "ccsds-c2": ["HLMinstarapproxi8PartialHardLimit", "HLAminstari8"]}


@functools.cache
def _layered_case(code, decoder):
    jlg, tlg = lifted_graphs(code)
    batch, sigma, iters = LAYERED_CASES[code]
    x = llrs(tlg.n, batch, sigma, seed=5)
    if code == "bg2z16":
        x = np.concatenate([x, strong_llrs(tlg.n, 64, seed=6)])
    _, ja = jax_factory.make_arithmetic(decoder)
    return tlg, x, jax_layered(jlg, ja, jnp.asarray(x), iters)


@pytest.mark.parametrize(
    "code,decoder", [(c, n) for c, names in LAYERED_NAMES.items() for n in names]
)
def test_layered_decode_matches_jax(code, decoder):
    """``Decoder(..., device="cpu")`` (the tile glue onto the message
    kernel's plain version) and ``plain_layered_decode`` (the twin of the
    jnp path) against the JAX jnp path."""
    tlg, x, jout = _layered_case(code, decoder)
    iters = LAYERED_CASES[code][2]
    dec = Decoder(code_objects(code, torch_codes), decoder, device="cpu")
    assert dec.schedule == "layered"
    assert_same_decode(jout, dec.decode_batch(x, max_iterations=iters))
    if code == "bg2z16":
        _, ta = make_arithmetic(decoder)
        assert_same_decode(
            jout, lifted_layered.plain_layered_decode(tlg, ta, torch.from_numpy(x), iters)
        )


@pytest.mark.parametrize("decoder", ["HLMinstarapproxi8", "Aminstari8PartialHardLimit"])
def test_no_iteration_keeps_the_raw_bits(decoder):
    """With max_iterations = 0 a frame that fails its checks keeps the hard
    decisions of the raw channel LLRs, not of the quantized ones: LLRs in
    (0, 1/16) quantize to 0, whose hard decision is 1. (The JAX package's
    decodes return the raw decisions there too: ``hard0``.)"""
    _, tlg = lifted_graphs("bg2z16")
    rng = np.random.default_rng(4)
    x = rng.uniform(1e-4, 0.06, (16, tlg.n)).astype(np.float32)
    x[:, ::7] *= -1.0
    x[0] = np.abs(x[0])  # the all-zero word: satisfied at iteration 0
    out = Decoder((BaseGraph.BG2, 16), decoder, device="cpu").decode_batch(x, max_iterations=0)
    np.testing.assert_array_equal(out["codeword"].numpy(), (x <= 0).astype(np.uint8))
    assert out["success"].tolist() == [True] + [False] * 15
    assert not out["iterations"].any()


@pytest.mark.parametrize("decoder", ["HLMinstarapproxi8", "Aminstari8"])
def test_streaming_refuses_i8(decoder):
    """``resident=False`` of an i8 name (the streaming sweep or phases, on
    the CPU their plain versions, under staged compaction with int16 and
    int8 state) equals the resident decode of the same name, on a mix of
    noisy and large-magnitude frames. (The name dates from when the
    streaming kernels had no i8 instances and this raised.)"""
    _, tlg = lifted_graphs("bg2z16")
    _, ta = make_arithmetic(decoder)
    decode = (lifted_layered.lifted_layered_decode if decoder.startswith("HL")
              else lifted_flooding.lifted_flooding_decode)
    x = torch.from_numpy(np.concatenate([llrs(tlg.n, 40, 1.3, seed=1),
                                         strong_llrs(tlg.n, 8, seed=2)]))
    stream = decode(tlg, ta, x, 8, resident=False)
    resident = decode(tlg, ta, x, 8)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(stream[key], resident[key]), key
    assert 0 < int(stream["success"].sum()) < 48
