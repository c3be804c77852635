"""The streaming path of the i8 names (``resident=False``) against the JAX
package, bit for bit (tolerance 0: integer arithmetic).

Phase level: the port's plain ``fused_check_reference`` and
``fused_var_reference`` (the update and the initialisation) and
``fused_layered_iteration_reference`` (one and two sweeps, int16 Qv)
against JAX's Pallas ``fused_check``, ``fused_var`` and
``fused_layered_iteration`` in interpret mode, on the same planes of 5G
BG2 z=16 (one JAX tile of 128 frames): int8 messages over the whole range
with the values where the partial hard limit (100), the Deg1Clip (116)
and the Jones clip (127) act, and posteriors from noisy and
large-magnitude frames.

Decode level: ``lifted_flooding_decode`` and ``lifted_layered_decode``
with ``resident=False`` (the phases or the sweep under staged
compaction) against the JAX jnp paths (``fused=False``; interpret mode
would take minutes a decode), on 5G BG2 z=16 with 64 large-magnitude
frames besides and on DVB-S2 R1_4short, both families a schedule; each
also equals the port's resident decode of the same name. The CUDA
instances are held against these plain versions in test_torch_cuda.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode as jax_flooding
from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode as jax_layered
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_tpu.ops.fused_layered import (
    fused_layered_iteration as jax_fused_layered_iteration,
)
from ldpc_toolbox_torch.convert import layout_to_device
from ldpc_toolbox_torch.decoder import lifted_flooding, lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops import fused_bp2
from ldpc_toolbox_torch.ops.fused_layered import fused_layered_iteration_reference

from torch_parity import assert_same_decode, lifted_graphs, llrs, strong_llrs

#: one JAX tile of 128 frames on 5G BG2 z=16
JAX_BT = 128


@functools.cache
def _layouts():
    jlg, tlg = lifted_graphs("bg2z16")
    return (jax_fused_bp2.build_fused_layout(jlg),
            layout_to_device(fused_bp2.build_fused_layout(tlg), "cpu"))


def _rules(decoder):
    return (jax_fused_bp2.rule_for(jax_factory.make_arithmetic(decoder)[1]),
            fused_bp2.rule_for(make_arithmetic(decoder)[1]))


def _int8_planes(planes, seed):
    """(1, planes, Z, 128) int8 values over [-127, 127], a third of them
    at the values where the clips and the hard limit act."""
    shape = (1, planes, _layouts()[1].Z, JAX_BT)
    rng = np.random.default_rng(seed)
    special = rng.choice([127, -127, 117, -117, 116, -116, 100, -100, 99, 0, 1, -1], shape)
    v = np.where(rng.random(shape) < 0.3, special, rng.integers(-127, 128, shape))
    return v.astype(np.int8)


def _same(jax_array, tensor):
    assert str(tensor.dtype).split(".")[-1] == jnp.dtype(jax_array.dtype).name
    np.testing.assert_array_equal(np.asarray(jax_array), tensor.numpy())


@pytest.mark.parametrize("decoder", ["Minstarapproxi8PartialHardLimit",
                                     "Aminstari8PartialHardLimit"])
def test_check_phase_matches_jax(decoder):
    jl, tl = _layouts()
    jrule, rule = _rules(decoder)
    v2c = _int8_planes(tl.E, seed=1)
    c2v = fused_bp2.fused_check_reference(torch.from_numpy(v2c), tl, rule)
    _same(jax_fused_bp2.fused_check(jnp.asarray(v2c), jl, jrule), c2v)
    assert (c2v.abs() == 127).any() and (c2v == 0).any()


@pytest.mark.parametrize("init", [False, True], ids=["update", "init"])
def test_var_phase_matches_jax(init):
    """The update under Jones and Deg1Clip (5G BG2 has degree-1 variable
    groups), and the initialisation, which applies no clip."""
    jl, tl = _layouts()
    jrule, rule = _rules("Minstarapproxi8JonesDeg1Clip")
    q = _int8_planes(tl.VG, seed=2)
    c2v = None if init else _int8_planes(tl.E, seed=3)
    v2c, bits = fused_bp2.fused_var_reference(
        None if init else torch.from_numpy(c2v), torch.from_numpy(q), tl, rule)
    jv2c, jbits = jax_fused_bp2.fused_var(None if init else jnp.asarray(c2v),
                                          jnp.asarray(q), jl, jrule)
    _same(jv2c, v2c)
    _same(jbits, bits)
    assert 0 < int(bits.sum()) < bits.numel()


@pytest.mark.parametrize("decoder", ["HLMinstarapproxi8PartialHardLimit",
                                     "HLAminstari8PartialHardLimit"])
def test_sweep_matches_jax(decoder):
    """One and two sweeps from the quantized channel posteriors (int16) of
    64 noisy and 64 large-magnitude frames and a zero Rcv."""
    jl, tl = _layouts()
    jrule, rule = _rules(decoder)
    _, tlg = lifted_graphs("bg2z16")
    x = np.concatenate([llrs(tlg.n, 64, 1.3, seed=5), strong_llrs(tlg.n, 64, seed=6)])
    qv0, _, _, _ = lifted_layered.tile_inputs(tlg, make_arithmetic(decoder)[1],
                                              torch.from_numpy(x))
    qv = qv0.permute(1, 2, 0, 3).reshape(1, tl.VG, tl.Z, JAX_BT).contiguous()
    assert qv.dtype == torch.int16
    rcv = torch.zeros((1, tl.E, tl.Z, JAX_BT), dtype=torch.int8)
    # copies: a JAX array made from a numpy array may share its memory,
    # and the plain version updates qv and rcv in place
    jqv, jrcv = jnp.asarray(qv.numpy().copy()), jnp.asarray(rcv.numpy().copy())
    for _ in range(2):
        out = fused_layered_iteration_reference(qv, rcv, tl, rule)
        jqv, jrcv, jbits = jax_fused_layered_iteration(jqv, jrcv, jl, jrule)
        for j, t in zip((jqv, jrcv, jbits), out):
            _same(j, t)
    assert (rcv.abs() == 127).any()


#: decode cases: (code, schedule) -> (batch, sigma, iterations), those of
#: tests/test_torch_i8_flooding.py and tests/test_torch_i8.py; the 5G BG2
#: z=16 batch holds 64 large-magnitude frames besides
DECODE_CASES = {("bg2z16", "flooding"): (136, 1.3, 10), ("R1_4short", "flooding"): (64, 0.9, 8),
                ("bg2z16", "layered"): (136, 1.45, 8), ("R1_4short", "layered"): (64, 1.05, 6)}
DECODE_NAMES = ["Minstarapproxi8JonesPartialHardLimitDeg1Clip", "Aminstari8JonesDeg1Clip",
                "HLMinstarapproxi8PartialHardLimit", "HLAminstari8"]


@functools.cache
def _decode_inputs(code, schedule):
    jlg, tlg = lifted_graphs(code)
    batch, sigma, _ = DECODE_CASES[code, schedule]
    x = llrs(tlg.n, batch, sigma, seed=5)
    if code == "bg2z16":
        x = np.concatenate([x, strong_llrs(tlg.n, 64, seed=6)])
    return jlg, tlg, x


@pytest.mark.parametrize("decoder", DECODE_NAMES)
@pytest.mark.parametrize("code", ["bg2z16", "R1_4short"])
def test_streaming_decode_matches_jax(code, decoder):
    layered = decoder.startswith("HL")
    schedule = "layered" if layered else "flooding"
    jlg, tlg, x = _decode_inputs(code, schedule)
    iters = DECODE_CASES[code, schedule][2]
    _, ja = jax_factory.make_arithmetic(decoder)
    _, ta = make_arithmetic(decoder)
    jax_decode = jax_layered if layered else jax_flooding
    decode = (lifted_layered.lifted_layered_decode if layered
              else lifted_flooding.lifted_flooding_decode)
    jout = jax_decode(jlg, ja, jnp.asarray(x), iters, fused=False)
    stream = decode(tlg, ta, torch.from_numpy(x), iters, resident=False)
    assert_same_decode(jout, stream)
    resident = decode(tlg, ta, torch.from_numpy(x), iters)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(stream[key], resident[key]), key
