"""The plain versions of the port's flooding phase kernels against the JAX
package's Pallas phase kernels (interpret mode on the CPU), at tolerance
0, on the same planes.

Codes: 5G BG2 Z=16 and DVB-S2 R1_4short (two check buckets, three
variable buckets, missing lanes). The CUDA kernels are held against these
plain versions in test_torch_cuda.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_torch.convert import layout_to_device
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops import fused_bp2

from torch_parity import lifted_graphs

#: code -> batch
CASES = {"bg2z16": 256, "R1_4short": 128}
DECODERS = ["Minsumf32", "Minsumbf16", "Normminsumbf16"]
#: the JAX kernels' tile width
JAX_BT = 128


@functools.cache
def _layouts(code):
    """(JAX FusedLayout, port DeviceLayout on the CPU) of a test code."""
    jlg, tlg = lifted_graphs(code)
    return (
        jax_fused_bp2.build_fused_layout(jlg),
        layout_to_device(fused_bp2.build_fused_layout(tlg), "cpu"),
    )


def _rules(decoder):
    return (
        jax_fused_bp2.rule_for(jax_factory.make_arithmetic(decoder)[1]),
        fused_bp2.rule_for(make_arithmetic(decoder)[1]),
    )


def _planes(shape, decoder, seed):
    """Seeded message planes in the decoder's storage type, as a JAX array
    and a torch tensor holding the same values."""
    x = (5.0 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32
    )
    if decoder == "Minsumf32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _same(jax_array, tensor):
    np.testing.assert_array_equal(
        np.asarray(jax_array.astype(jnp.float32)), tensor.float().numpy()
    )


def _tile_shape(code, planes):
    nbt = CASES[code] // JAX_BT
    return (nbt, planes, _layouts(code)[1].Z, JAX_BT)


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("code", list(CASES))
def test_check_phase_matches_jax(code, decoder):
    jl, tl = _layouts(code)
    jrule, rule = _rules(decoder)
    jv2c, v2c = _planes(_tile_shape(code, tl.E), decoder, seed=1)
    c2v = fused_bp2.fused_check_reference(v2c, tl, rule)
    assert c2v.dtype == v2c.dtype
    _same(jax_fused_bp2.fused_check(jv2c, jl, jrule), c2v)


@functools.cache
def _jax_var(code, decoder, init):
    """JAX ``fused_var`` outputs on the seeded planes. The variable phase
    reads no scale, so Minsumbf16 and Normminsumbf16 share one run."""
    if decoder == "Normminsumbf16":
        return _jax_var(code, "Minsumbf16", init)
    jl, tl = _layouts(code)
    jq, _ = _planes(_tile_shape(code, tl.VG), decoder, seed=2)
    jc2v = None if init else _planes(_tile_shape(code, tl.E), decoder, seed=3)[0]
    return jax_fused_bp2.fused_var(jc2v, jq, jl, _rules(decoder)[0])


@pytest.mark.parametrize("init", [False, True], ids=["update", "init"])
@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("code", list(CASES))
def test_var_phase_matches_jax(code, decoder, init):
    _, tl = _layouts(code)
    _, q = _planes(_tile_shape(code, tl.VG), decoder, seed=2)
    c2v = None if init else _planes(_tile_shape(code, tl.E), decoder, seed=3)[1]
    v2c, bits = fused_bp2.fused_var_reference(c2v, q, tl, _rules(decoder)[1])
    jv2c, jbits = _jax_var(code, decoder, init)
    _same(jv2c, v2c)
    np.testing.assert_array_equal(np.asarray(jbits), bits.numpy())
    assert bits.dtype == torch.int8 and 0 < int(bits.sum()) < bits.numel()


@pytest.mark.parametrize("code", list(CASES))
def test_syndrome_matches_jax(code):
    """Random bits fail everywhere; bits of the all-zero codeword with a
    few flipped frames fail exactly there."""
    jl, tl = _layouts(code)
    shape = _tile_shape(code, tl.VG)
    rng = np.random.default_rng(4)
    bits = np.zeros(shape, np.int8)
    bits[:, :, :, 5] = rng.integers(0, 2, shape[:3])
    bits[0, 3, 7, 9] = 1  # one flipped bit
    for b in (bits, rng.integers(0, 2, shape).astype(np.int8)):
        flags = fused_bp2.fused_syndrome_bits_reference(torch.from_numpy(b), tl)
        jflags = jax_fused_bp2.fused_syndrome_bits(jnp.asarray(b), jl)
        np.testing.assert_array_equal(np.asarray(jflags)[:, 0, :], flags.numpy())
        assert flags.dtype == torch.int32 and 0 < int(flags.sum())
    assert flags.sum() == flags.numel()
