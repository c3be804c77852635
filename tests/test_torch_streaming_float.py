"""The streaming phases of the float names against the JAX package: the
port's plain ``fused_check_reference`` (the four rules in f32 and f64) and
``fused_var_reference`` (the update in f32 and f64, the initialisation in
f64) against JAX's Pallas ``fused_check`` and ``fused_var`` in interpret
mode, on the same planes of 5G BG2 z=16 (one JAX tile of 128 frames):
messages over eight decades of magnitude, exact zeros and values above 87,
where f32 exp(-x) is subnormal.

Within the tolerances of tests/test_torch_float.py: rtol 1e-5, atol 1e-30
(f32) and rtol 1e-12, atol 1e-300 (f64), the absolute terms for XLA's
flush of subnormals to zero on the CPU. As there, exp, log, log1p and tanh
are torch's on both sides (``torch_parity.torch_transcendentals``, through
``jax.pure_callback`` inside the interpreted kernel): XLA's CPU
transcendentals are other approximations, which the rules' cancellations
amplify beyond rtol. The sweeps are in test_torch_streaming_float_sweep.py,
the decodes in test_torch_streaming_float_decodes.py; the CUDA instances
are held against these plain versions in test_torch_cuda.py."""

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

from torch_parity import lifted_graphs, torch_transcendentals

#: one JAX tile of 128 frames on 5G BG2 z=16
JAX_BT = 128
#: (rtol, atol) by storage type, those of tests/test_torch_float.py
TOLERANCE = {np.float32: (1e-5, 1e-30), np.float64: (1e-12, 1e-300)}
FLOAT_NAMES = [r + p for r in ("Phi", "Tanh", "Minstarapprox", "Aminstar") for p in ("f32", "f64")]


@functools.cache
def _layouts():
    jlg, tlg = lifted_graphs("bg2z16")
    return (jax_fused_bp2.build_fused_layout(jlg),
            layout_to_device(fused_bp2.build_fused_layout(tlg), "cpu"))


def _rules(decoder):
    return (jax_fused_bp2.rule_for(jax_factory.make_arithmetic(decoder)[1]),
            fused_bp2.rule_for(make_arithmetic(decoder)[1]))


def _dtype(decoder):
    return np.float64 if decoder.endswith("f64") else np.float32


def _planes(planes, dtype, seed):
    """(1, planes, Z, 128) messages: magnitudes from 1e-3 to 200 (exact
    zeros too) with random signs."""
    shape = (1, planes, _layouts()[1].Z, JAX_BT)
    rng = np.random.default_rng(seed)
    scale = rng.choice([0.0, 1e-3, 0.03, 0.5, 3.0, 20.0, 95.0, 200.0], shape)
    x = scale * rng.uniform(0.5, 1.0, shape) * rng.choice([-1.0, 1.0], shape)
    return x.astype(dtype)


def _close(jax_array, tensor):
    dtype = _dtype_of(tensor)
    assert jnp.dtype(jax_array.dtype) == np.dtype(dtype)
    rtol, atol = TOLERANCE[dtype]
    np.testing.assert_allclose(np.asarray(jax_array), tensor.numpy(), rtol=rtol, atol=atol)


def _dtype_of(tensor):
    return np.float64 if tensor.dtype == torch.float64 else np.float32


@pytest.mark.parametrize("decoder", FLOAT_NAMES)
def test_check_phase_matches_jax(decoder, monkeypatch):
    torch_transcendentals(monkeypatch, jax_fused_bp2)
    jl, tl = _layouts()
    jrule, rule = _rules(decoder)
    v2c = _planes(tl.E, _dtype(decoder), seed=1)
    c2v = fused_bp2.fused_check_reference(torch.from_numpy(v2c), tl, rule)
    assert c2v.dtype == rule.storage_dtype
    _close(jax_fused_bp2.fused_check(jnp.asarray(v2c), jl, jrule), c2v)
    assert torch.isfinite(c2v).all()


@pytest.mark.parametrize("decoder,init", [("Phif32", False), ("Phif64", False),
                                          ("Phif64", True)])
def test_var_phase_matches_jax(decoder, init, monkeypatch):
    """The float rules share the variable rule (sum in slot order, each
    output tot - own); the update in both precisions and the
    initialisation (every output q, big at the missing lanes)."""
    torch_transcendentals(monkeypatch, jax_fused_bp2)
    jl, tl = _layouts()
    jrule, rule = _rules(decoder)
    dtype = _dtype(decoder)
    q = _planes(tl.VG, dtype, seed=2)
    c2v = None if init else _planes(tl.E, dtype, seed=3)
    v2c, bits = fused_bp2.fused_var_reference(
        None if init else torch.from_numpy(c2v), torch.from_numpy(q), tl, rule)
    jv2c, jbits = jax_fused_bp2.fused_var(None if init else jnp.asarray(c2v),
                                          jnp.asarray(q), jl, jrule)
    _close(jv2c, v2c)
    np.testing.assert_array_equal(np.asarray(jbits), bits.numpy())
    assert 0 < int(bits.sum()) < bits.numel()
