"""The port's min-sum arithmetic, kernel rule and decoder registry against
the JAX package's, bit for bit (tolerance 0: the same operations in the
same order on the same f32 values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_torch.decoder import factory
from ldpc_toolbox_torch.ops import fused_bp2

MINSUM = ["Minsumf32", "Minsumbf16", "Normminsumf32", "Normminsumbf16"]


def _block(shape, seed):
    """f32 values with +-0.0, ties, bf16-rounded values and magnitudes up
    to the f32 maximum (beyond the bf16 maximum the kernel rule's `big`).
    No subnormals: XLA on the CPU flushes them to zero, torch does not."""
    rng = np.random.default_rng(seed)
    special = np.array(
        [0.0, -0.0, 1.5, -1.5, 1.5, 3.0e38, -3.3895314e38, 3.4e38, 2.0, -2.0, 1e30],
        np.float32,
    )
    normal = rng.standard_normal(shape).astype(np.float32) * 8
    x = np.where(
        rng.random(shape) < 0.4, rng.choice(special, shape), normal
    ).astype(np.float32)
    # a share of values already rounded to bf16, as loaded from storage
    bf = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return np.where(rng.random(shape) < 0.3, bf, x)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", MINSUM)
@pytest.mark.parametrize("masked", [False, True])
def test_check_messages_matches_jax(name, masked):
    x = _block((40, 7, 33), seed=1)
    mask = None
    if masked:
        mask = np.random.default_rng(2).random((40, 7)) < 0.8
    _, ja = jax_factory.make_arithmetic(name)
    _, ta = factory.make_arithmetic(name)
    jout = ja.check_messages(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask)
    )
    tout = ta.check_messages(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)
    )
    assert tout.dtype == torch.float32
    np.testing.assert_array_equal(_bits(jout), _bits(tout.numpy()))


@pytest.mark.parametrize("name", MINSUM)
@pytest.mark.parametrize("d", [3, 7])
def test_minsum_rule_check_matches_jax(name, d):
    planes = _block((d, 16, 24), seed=d)
    jrule = jax_fused_bp2.rule_for(jax_factory.make_arithmetic(name)[1])
    trule = fused_bp2.rule_for(factory.make_arithmetic(name)[1])
    assert trule.big == jrule.big and trule.scale == jrule.scale
    jout = jrule.check([jnp.asarray(p) for p in planes])
    tout = trule.check(torch.from_numpy(planes))
    for t in range(d):
        np.testing.assert_array_equal(_bits(jout[t]), _bits(tout[t].numpy()))


@pytest.mark.parametrize("name", MINSUM)
def test_arithmetic_dtypes_and_helpers(name):
    _, ja = jax_factory.make_arithmetic(name)
    _, ta = factory.make_arithmetic(name)
    for prop in ("storage_dtype", "compute_dtype", "var_llr_storage_dtype"):
        assert str(getattr(ta, prop)).split(".")[-1] == jnp.dtype(
            getattr(ja, prop)
        ).name, prop
    assert ta.scale == ja.scale and ta.is_int8 is False
    x = _block((5, 9), seed=4)
    r = _block((5, 9), seed=5)
    pairs = [
        (ja.quantize(jnp.asarray(x)), ta.quantize(torch.from_numpy(x))),
        (ja.llr_to_var_llr(jnp.asarray(x)), ta.llr_to_var_llr(torch.from_numpy(x))),
        (ja.var_llr_to_llr(jnp.asarray(x)), ta.var_llr_to_llr(torch.from_numpy(x))),
        (ja.layered_x(jnp.asarray(x), jnp.asarray(r)),
         ta.layered_x(torch.from_numpy(x), torch.from_numpy(r))),
        (ja.layered_qv_delta(jnp.asarray(x), jnp.asarray(r)),
         ta.layered_qv_delta(torch.from_numpy(x), torch.from_numpy(r))),
    ]
    for j, t in pairs:
        np.testing.assert_array_equal(_bits(j), _bits(t.numpy()))
    np.testing.assert_array_equal(
        np.asarray(ja.hard_decision(jnp.asarray(x))),
        ta.hard_decision(torch.from_numpy(x)).numpy(),
    )


def test_registry_names_match_jax():
    assert list(factory.DECODER_IMPLEMENTATIONS) == list(
        jax_factory.DECODER_IMPLEMENTATIONS
    )
    assert len(factory.DECODER_IMPLEMENTATIONS) == 44
    for name, (schedule, _) in factory.DECODER_IMPLEMENTATIONS.items():
        assert schedule == jax_factory.DECODER_IMPLEMENTATIONS[name][0]
        _, a = factory.make_arithmetic(name)
        _, ja = jax_factory.make_arithmetic(name)
        assert type(a).__name__ == type(ja).__name__, name
        # every name's types are the JAX package's (x64: f64 names in f64)
        for prop in ("storage_dtype", "compute_dtype", "var_llr_storage_dtype"):
            assert str(getattr(a, prop)).split(".")[-1] == jnp.dtype(getattr(ja, prop)).name
    with pytest.raises(ValueError):
        factory.make_arithmetic("Nosuchdecoder")
