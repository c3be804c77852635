"""The generic parity-check path's jax-free layout and rules against the JAX
package's: ``decoder/layout.DecodeGraph`` field by field, and the
arithmetic's ``check_messages`` and ``var_update``, which the generic
decodes run (``systematic``, the encode side, is held in
tests/test_torch_generic_ber.py).

The float ``check_messages`` are held to the JAX ones within the
tolerances of tests/test_torch_float.py (rtol 1e-5, atol 1e-30 in f32;
rtol 1e-12, atol 1e-300 in f64; the absolute terms cover XLA's flush of
subnormals to zero on the CPU), with the JAX module's exp, expm1, log,
log1p, tanh and arctanh evaluated by torch: XLA's own CPU transcendentals
are other approximations (tests/test_torch_float.py measures the gaps).
The variable rule adds in slot order on both sides and is held bit for
bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu import sparse as jax_sparse
from ldpc_toolbox_tpu.decoder import arithmetic as jax_arithmetic
from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.layout import DecodeGraph as JaxGraph
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch import sparse as torch_sparse
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.layout import DecodeGraph

from torch_parity import generic_h, torch_transcendentals

#: the codes of the layout check: MacKay-Neal and PEG (n = 1024), 5G BG2
#: z=16, AR4JA K=1024 rate 1/2, CCSDS C2 and DVB-S2 R1_4short
LAYOUT_CODES = ["mn", "peg", "bg2z16", "ar4ja-1/2", "ccsds-c2", "R1_4short"]
FLOAT_NAMES = [r + p for r in ("Phi", "Tanh", "Minstarapprox", "Aminstar")
               for p in ("f32", "f64")]
TOLERANCE = {np.float32: (1e-5, 1e-30), np.float64: (1e-12, 1e-300)}
TRANSCENDENTALS = ("exp", "expm1", "log", "log1p", "tanh", "arctanh")


def _both(name):
    return (generic_h(name, jax_sparse, jax_codes),
            generic_h(name, torch_sparse, torch_codes))


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a is not None and b is not None, what
        np.testing.assert_array_equal(a, b, err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
    else:
        assert a == b, what


@pytest.mark.parametrize("code", LAYOUT_CODES)
def test_decode_graph_copy_matches_jax(code):
    jh, th = _both(code)
    jg, tg = JaxGraph.from_sparse(jh), DecodeGraph.from_sparse(th)
    for f in dataclasses.fields(JaxGraph):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if f.name.endswith("_buckets"):
            assert len(a) == len(b), f.name
            for i, (x, y) in enumerate(zip(a, b)):
                for g in dataclasses.fields(x):
                    _same(getattr(x, g.name), getattr(y, g.name), f"{f.name}[{i}].{g.name}")
        else:
            _same(a, b, f.name)


def _messages(d, dtype, seed, masked):
    """(rows, d, batch) inputs of magnitudes 0 to 60 over six decades, with
    exact zeros and ties, and a (rows, d) mask whose valid slots are a
    prefix of each row (the padded layout's; at least one slot) or None."""
    rng = np.random.default_rng(seed)
    rows, batch = 24, 40
    scale = rng.choice([0.0, 1e-3, 0.05, 0.5, 3.0, 20.0, 60.0], (rows, d, batch))
    x = scale * rng.uniform(0.5, 1.0, (rows, d, batch)) * rng.choice([-1.0, 1.0], (rows, d, batch))
    if d >= 2:
        x[:, :2, :4] = [[1.5], [-1.5]]
    mask = None
    if masked:
        mask = np.arange(d)[None, :] < rng.integers(1, d + 1, rows)[:, None]
    return x.astype(dtype), mask


@pytest.mark.parametrize("name", FLOAT_NAMES)
def test_float_check_messages_match_jax(name, monkeypatch):
    """Masked and unmasked, at check degrees 1 to 32, in each precision;
    the masked slots' outputs are not compared (the decodes replace
    them)."""
    torch_transcendentals(monkeypatch, jax_arithmetic, TRANSCENDENTALS)
    _, ja = jax_factory.make_arithmetic(name)
    _, ta = make_arithmetic(name)
    dtype = np.float64 if name.endswith("f64") else np.float32
    rtol, atol = TOLERANCE[dtype]
    unmasked, masked_check = jax.jit(ja.check_messages), jax.jit(ja.check_messages)
    for d in (1, 2, 3, 6, 19, 32):
        for masked in (False, True):
            x, mask = _messages(d, dtype, seed=d, masked=masked)
            jout = np.asarray(unmasked(jnp.asarray(x)) if mask is None
                              else masked_check(jnp.asarray(x), jnp.asarray(mask)))
            tout = ta.check_messages(
                torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
            assert tout.dtype == ta.dtype
            keep = np.ones(x.shape, bool) if mask is None else np.broadcast_to(mask[..., None], x.shape)
            np.testing.assert_allclose(tout.numpy()[keep], jout[keep], rtol=rtol, atol=atol,
                                       err_msg=f"{name} d={d} masked={masked}")


@pytest.mark.parametrize("name", ["Phif64", "Phif32", "Minsumbf16", "Minstarapproxi8Deg1Clip"])
def test_var_update_matches_jax(name):
    """The base variable rule (the float and min-sum names; the i8 names
    add their clips) on every bucket degree of the generic layouts, masked
    and unmasked, bit for bit: both sides sum c2v in slot order, then add
    the channel LLR."""
    _, ja = jax_factory.make_arithmetic(name)
    _, ta = make_arithmetic(name)
    for d in (1, 2, 3, 6, 11):
        for masked in (False, True):
            x, mask = _messages(d, np.float64, seed=10 + d, masked=masked)
            q = x[:, 0] * 3
            if ta.is_int8:
                x, q = np.clip(np.round(x * 2), -127, 127), np.clip(np.round(q * 2), -127, 127)
            dt = np.int32 if ta.is_int8 else np.dtype(str(ta.compute_dtype).split(".")[-1])
            x, q = x.astype(dt), q.astype(dt)
            jm = None if mask is None else jnp.asarray(mask)
            tm = None if mask is None else torch.from_numpy(mask)
            jv, jt = ja.var_update(jnp.asarray(q), jnp.asarray(x), jm)
            tv, tt = ta.var_update(torch.from_numpy(q), torch.from_numpy(x), tm)
            np.testing.assert_array_equal(np.asarray(jt), tt.numpy(), err_msg=f"{name} d={d}")
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy(), err_msg=f"{name} d={d}")
