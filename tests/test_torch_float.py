"""The port's four float rules (Phi, Tanh, Minstarapprox, Aminstar; f32 and
f64) and its float layered decodes against the JAX package's.

Rule level: the port's ``PhiRule``, ``TanhRule``, ``MinstarApproxRule`` and
``AminstarRule`` against the JAX kernel rules of the same names (plain jnp
on lists of planes, no Pallas), at check degrees 1 to 32 with magnitudes
from 0 to 200 (exact zeros, ties, values above 87 where f32 exp(-x) is
subnormal), within rtol 1e-5, atol 1e-30 (f32) and rtol 1e-12, atol 1e-300
(f64). The absolute terms cover XLA's flush of subnormals to zero on the
CPU, which torch does not do, and nothing else. Both sides evaluate exp,
log, log1p and tanh with torch's CPU functions (the JAX module's ``jnp``
is wrapped for the test): XLA's own CPU transcendentals are other
approximations (its f32 tanh(9) is 1.0, not 0.99999994), and the rules'
cancellations (Tanh at the clamps, Aminstar's min* near equal inputs)
amplify one ulp there into more than rtol; what the test holds is the
rules' operations, their order and their types.

Decode level: ``Decoder(..., device="cpu")`` (the tile glue onto the float
instances' plain version) against the JAX jnp layered path
(``lifted_layered_decode``, ``fused=False``, with XLA's own
transcendentals) on the workload on which the JAX package holds its float
Pallas kernels to that path (tests/test_lifted_layered.py
test_fused_layered_matches_jnp: DVB-S2 R1_4short, B = 128, sigma 0.9,
seed 5, 8 iterations), and on 5G BG2 z=16: equal success, iterations and
codewords on every frame. The flooding decodes, the defaults and the
refusals are in test_torch_float_flooding.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode as jax_layered
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.decoder import Decoder
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops import fused_bp2

from torch_parity import assert_same_decode, code_objects, lifted_graphs, llrs

#: the 8 flooding float names; ``HL`` + each is layered
FLOAT_NAMES = [r + p for r in ("Phi", "Tanh", "Minstarapprox", "Aminstar")
               for p in ("f32", "f64")]
#: (rtol, atol) by storage type: atol covers XLA's subnormal flush only
TOLERANCE = {np.float32: (1e-5, 1e-30), np.float64: (1e-12, 1e-300)}
DEGREES = (1, 2, 3, 7, 19, 32)


class _TorchTranscendentals:
    """``jax.numpy`` with exp, log, log1p and tanh computed by torch."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def _via(fn):
        return lambda x: jnp.asarray(fn(torch.from_numpy(np.array(x))).numpy())


for _name in ("exp", "log", "log1p", "tanh"):
    setattr(_TorchTranscendentals, _name,
            staticmethod(_TorchTranscendentals._via(getattr(torch, _name))))


def _check_inputs(d, dtype, seed):
    """(d, 192) check inputs: magnitudes 0 to 200 over eight decades, with
    exact zeros, values above 87, a column of equal inputs and columns
    whose two least magnitudes tie (Aminstar's first-minimum argmin)."""
    rng = np.random.default_rng(seed)
    scale = rng.choice([0.0, 1e-3, 0.03, 0.5, 3.0, 20.0, 95.0, 200.0], (d, 192))
    x = scale * rng.uniform(0.5, 1.0, (d, 192)) * rng.choice([-1.0, 1.0], (d, 192))
    x[:, 0] = 2.5
    if d >= 2:
        x[:2, 1:9] = [[1.5], [-1.5]]
        x[rng.permutation(d)[:2], 9] = 0.0
    return x.astype(dtype)


@pytest.mark.parametrize("name", FLOAT_NAMES)
def test_float_rules_match_jax(name, monkeypatch):
    """``check`` of each rule, at degrees 1 to 32 (MinstarApprox's cap), in
    its precision; ``var``, ``layered_x``, the types, big and the Tanh
    clamps."""
    jrule = jax_fused_bp2.rule_for(jax_factory.make_arithmetic(name)[1])
    trule = fused_bp2.rule_for(make_arithmetic(name)[1])
    assert type(trule).__name__ == type(jrule).__name__
    assert fused_bp2.is_float_rule(trule) and not fused_bp2.is_i8(trule)
    dtype = np.float64 if name.endswith("f64") else np.float32
    for prop in ("storage_dtype", "compute_dtype"):
        assert str(getattr(trule, prop)).split(".")[-1] == np.dtype(dtype).name, prop
        assert jnp.dtype(getattr(jrule, prop)) == np.dtype(dtype), prop
    assert trule.big == jrule.big == float(np.finfo(dtype).max)
    if name.startswith("Tanh"):
        assert (trule.clamp, trule.prod_max) == (jrule.clamp, jrule.prod_max)
        assert trule.prod_max == float(np.nextafter(dtype(1), dtype(0)))
    monkeypatch.setattr(jax_fused_bp2, "jnp", _TorchTranscendentals())
    rtol, atol = TOLERANCE[dtype]
    for d in DEGREES:
        x = _check_inputs(d, dtype, seed=d)
        assert (np.abs(x) > 87).any() and (x == 0).any()
        jout = np.stack([np.asarray(o) for o in jrule.check([jnp.asarray(p) for p in x])])
        tout = trule.check(torch.from_numpy(x))
        assert tout.dtype == trule.compute_dtype
        np.testing.assert_allclose(tout.numpy(), jout, rtol=rtol, atol=atol,
                                   err_msg=f"{name} d={d}")
        q = x[0] * 3
        jv, jt = jrule.var(jnp.asarray(q), [jnp.asarray(p) for p in x], d)
        tv, tt = trule.var(torch.from_numpy(q), list(torch.from_numpy(x)), d)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        for a, b in zip(jv, tv):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jrule.layered_x(jnp.asarray(x[0]), jnp.asarray(x[1]))),
        trule.layered_x(torch.from_numpy(x[0]), torch.from_numpy(x[1])).numpy(),
    )


def _ulp_gap(fn, arg):
    """The most ulps between XLA's and torch's ``fn`` on ``arg`` (either
    result subnormal or zero counts as equal: XLA flushes subnormals)."""
    j = np.asarray(getattr(jnp, fn)(jnp.asarray(arg)))
    t = getattr(torch, fn)(torch.from_numpy(arg)).numpy()
    keep = (np.abs(j) >= np.finfo(arg.dtype).tiny) & (np.abs(t) >= np.finfo(arg.dtype).tiny)
    it = np.int32 if arg.dtype == np.float32 else np.int64
    # ordered integer images of the floats, so that a difference counts ulps
    a, b = (np.where(v.view(it) < 0, np.iinfo(it).min - v.view(it).astype(np.int64),
                     v.view(it).astype(np.int64)) for v in (j[keep], t[keep]))
    return int(np.abs(a - b).max())


def _transcendental_gaps(dtype, clamp):
    """XLA's CPU exp, log, log1p and tanh against torch's, in ulps, over
    the arguments the rules give them: exp(-y) for y to 600, log1p on
    (-1, 1], log on [1/2, 1), tanh within the clamp."""
    y = np.concatenate([10.0 ** np.linspace(-8, np.log10(600), 20001), [0.0]])
    t = np.exp(-y)
    return {
        "exp": _ulp_gap("exp", (-y).astype(dtype)),
        "log1p": _ulp_gap("log1p", np.concatenate([t, -t[t < 1]]).astype(dtype)),
        "log": _ulp_gap("log", (1 - t[t <= 0.5]).astype(dtype)),
        "tanh": _ulp_gap("tanh", np.linspace(-clamp, clamp, 40001).astype(dtype)),
    }


#: the gaps measured on the CPU (jaxlib's XLA against torch): the test
#: fails if either library drifts further
MAX_GAPS = {np.float32: {"exp": 1, "log1p": 2, "log": 1, "tanh": 4},
            np.float64: {"exp": 2, "log1p": 128, "log": 1, "tanh": 7}}


@pytest.mark.parametrize("name", FLOAT_NAMES)
def test_float_rules_match_jax_own_transcendentals(name):
    """``check`` of each rule against the JAX rule with XLA's own exp, log,
    log1p and tanh (its CPU results, which differ from torch's by the ulp
    gaps of ``_transcendental_gaps``, measured here), at degrees 1 to 32,
    in each precision. The tolerance is set from those gaps: Phi and
    MinstarApprox within rtol and atol as above (their outputs move by a
    few gaps' worth relative); Aminstar within rtol and an absolute term of
    the log1p and exp gaps times the type's epsilon (its output subtracts
    two O(1) logs, so near 0 the error is absolute); Tanh, whose 2 atanh(p)
    has the condition 2 / (1 - p^2) as p nears +-1, within twice the first
    order effect of the gaps: the tanh gap on each of the d - 1 factors of
    p and a rounding a product, through that condition, plus the log1p gap
    on each log, with p computed here from the inputs in f64 (at the clamp
    the bound reaches the output's range, and is capped there)."""
    jrule = jax_fused_bp2.rule_for(jax_factory.make_arithmetic(name)[1])
    trule = fused_bp2.rule_for(make_arithmetic(name)[1])
    dtype = np.float64 if name.endswith("f64") else np.float32
    eps = float(np.finfo(dtype).eps)
    clamp = trule.clamp if name.startswith("Tanh") else 9.0
    gaps = _transcendental_gaps(dtype, clamp)
    for fn, gap in gaps.items():
        assert gap <= MAX_GAPS[dtype][fn], (fn, gap)
    rtol, atol = TOLERANCE[dtype]
    for d in DEGREES:
        x = _check_inputs(d, dtype, seed=d)
        jout = np.stack([np.asarray(o) for o in jrule.check([jnp.asarray(p) for p in x])])
        tout = trule.check(torch.from_numpy(x)).numpy()
        if name.startswith("Tanh"):
            th = np.tanh(np.clip(x.astype(np.float64) / 2, -clamp, clamp))
            p = np.stack([np.prod(np.delete(th, t, axis=0), axis=0) for t in range(d)])
            p = np.clip(p, -trule.prod_max, trule.prod_max)
            dp = np.abs(p) * ((d - 1) * gaps["tanh"] + d) * eps
            bound = (2 * dp / (1 - p * p)
                     + gaps["log1p"] * eps * (np.abs(np.log1p(p)) + np.abs(np.log1p(-p))))
            top = 2 * np.arctanh(trule.prod_max)
            tol = np.minimum(2 * bound, 2 * top) + rtol * np.abs(tout) + atol
        else:
            extra = max(gaps["exp"], gaps["log1p"]) * eps if name.startswith("Aminstar") else 0
            tol = rtol * np.abs(tout) + atol + extra
        err = np.abs(jout.astype(np.float64) - tout)
        worst = np.unravel_index(np.argmax(err - tol), err.shape)
        assert (err <= tol).all(), (
            f"{name} d={d}: slot {worst[0]} column {worst[1]}: {jout[worst]} against "
            f"{tout[worst]}, tolerance {tol[worst]}")


def test_float_rule_missing_lane_poke():
    """An input at big, the missing-lane poke, acts as an infinitely
    reliable bit-0 message: the other slots' outputs are those of the check
    without it (Phi, MinstarApprox, Aminstar), and Tanh treats it as
    tanh(clamp); no output is inf or NaN."""
    for name in FLOAT_NAMES:
        rule = fused_bp2.rule_for(make_arithmetic(name)[1])
        dtype = torch.float64 if name.endswith("f64") else torch.float32
        x = torch.from_numpy(_check_inputs(7, np.float64, seed=3)).to(dtype)
        poked = torch.cat([x, torch.full_like(x[:1], rule.big)])
        out = rule.check(poked)
        assert torch.isfinite(out).all(), name
        if not name.startswith("Tanh"):
            torch.testing.assert_close(out[:-1], rule.check(x), rtol=0, atol=0)


#: layered decode cases: code -> (batch, sigma, iterations, seed, names)
LAYERED_CASES = {
    "R1_4short": (128, 0.9, 8, 5, ["HLPhif32", "HLTanhf32", "HLMinstarapproxf32",
                                   "HLAminstarf32", "HLPhif64"]),
    "bg2z16": (96, 1.45, 8, 5, ["HLAminstarf64"]),
}


@functools.cache
def _layered_case(code, decoder):
    jlg, tlg = lifted_graphs(code)
    batch, sigma, iters, seed, _ = LAYERED_CASES[code]
    x = llrs(tlg.n, batch, sigma, seed=seed)
    _, ja = jax_factory.make_arithmetic(decoder)
    return x, jax_layered(jlg, ja, jnp.asarray(x), iters)


@pytest.mark.parametrize(
    "code,decoder",
    [(c, n) for c, case in LAYERED_CASES.items() for n in case[4]],
)
def test_float_layered_decode_matches_jax(code, decoder):
    x, jout = _layered_case(code, decoder)
    iters = LAYERED_CASES[code][2]
    dec = Decoder(code_objects(code, torch_codes), decoder, device="cpu")
    assert dec.schedule == "layered"
    out = dec.decode_batch(x, max_iterations=iters)
    s = np.asarray(jout["success"])
    differs = np.nonzero((s != out["success"].numpy())
                         | (np.asarray(jout["iterations"]) != out["iterations"].numpy()))[0]
    assert not differs.size, (
        f"{decoder} on {code} (seed {LAYERED_CASES[code][3]}): frame {differs[0]} differs")
    if code == "bg2z16":
        assert_same_decode(jout, out)
    else:  # the JAX package's workload, where most frames converge
        for key in ("success", "iterations", "codeword"):
            np.testing.assert_array_equal(np.asarray(jout[key]), out[key].numpy(), err_msg=key)
        assert s.sum() >= 100
