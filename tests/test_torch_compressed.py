"""The plain versions of the port's compressed check-state decodes against
the JAX package's compressed kernels (``ops/resident_compressed.py``, run
in interpret mode by setting its ``LDPC_FORCE_COMPRESSED`` switch) and, for
layered, its jnp path (``fused=False``), bit for bit in success,
iterations and codewords; and the decoders' routing by rule and storage
type. The CUDA kernels are held against these plain versions in
test_torch_cuda.py.

Case: 5G BG2 Z=16, B=256, sigma=1.3, 10 iterations (the JAX package's own
compressed-kernel case, tests/test_lifted_layered.py:309-340)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_flooding import (
    lifted_flooding_decode as jax_flooding,
)
from ldpc_toolbox_tpu.decoder.lifted_layered import (
    lifted_layered_decode as jax_layered,
)
from ldpc_toolbox_torch.decoder import lifted_flooding, lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted_flooding import flooding_tiles
from ldpc_toolbox_torch.decoder.lifted_layered import tile_inputs, tiles_to_output
from ldpc_toolbox_torch.ops import fused_bp2
from ldpc_toolbox_torch.ops.fused_bp2 import MinSumRule
from ldpc_toolbox_torch.ops.resident_compressed import (
    compressed_flooding_decode,
    compressed_layered_decode,
    takes_compressed_state,
)

from torch_parity import assert_same_decode, lifted_graphs, llrs

BATCH, SIGMA, ITERS = 256, 1.3, 10
LAYERED = ["HLMinsumf32", "HLMinsumbf16"]
FLOODING = ["Minsumf32", "Minsumbf16"]


@functools.cache
def _inputs():
    jlg, tlg = lifted_graphs("bg2z16")
    return jlg, tlg, llrs(tlg.n, BATCH, SIGMA, seed=11)


@functools.cache
def _jax(decoder, compressed):
    """The JAX decode of the case: its compressed kernel (interpret mode)
    or, with ``compressed=False``, the jnp layered path. The switch is set
    only for this call (the result is cached), so no other test sees it."""
    jlg, _, x = _inputs()
    _, ja = jax_factory.make_arithmetic(decoder)
    if not compressed:
        return jax_layered(jlg, ja, jnp.asarray(x), ITERS)
    decode = jax_layered if decoder.startswith("HL") else jax_flooding
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LDPC_FORCE_COMPRESSED", "1")
        out = decode(jlg, ja, jnp.asarray(x), ITERS, fused=True, resident=True)
        return {k: np.asarray(v) for k, v in out.items()}


def _port(decoder):
    """The port's compressed plain version on the case, through the
    decoders' tile glue."""
    _, tlg, x = _inputs()
    _, ta = make_arithmetic(decoder)
    llr = torch.from_numpy(x)
    if decoder.startswith("HL"):
        tiles = tile_inputs(tlg, ta, llr)
        out = compressed_layered_decode(*tiles, ITERS)
    else:
        tiles = flooding_tiles(tlg, ta, llr)
        out = compressed_flooding_decode(*tiles, ITERS)
    return tiles_to_output(tlg, *out, BATCH)


@pytest.mark.parametrize("decoder", LAYERED + FLOODING)
def test_matches_jax_compressed_kernel(decoder):
    assert_same_decode(_jax(decoder, True), _port(decoder))


@pytest.mark.parametrize("decoder", LAYERED)
def test_layered_matches_jax_jnp_path(decoder):
    """The JAX compressed layered kernel had no value check of its own;
    the port is held against the jnp path as well."""
    assert_same_decode(_jax(decoder, False), _port(decoder))


class _OtherF32Rule:
    """A float rule with f32 storage that is not ``MinSumRule``, as the
    float families' rules will be: min-sum's arithmetic underneath, so that
    the message kernels' plain versions decode with it."""

    def __init__(self):
        self._inner = MinSumRule(torch.float32)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _routed(monkeypatch, module, schedule):
    """Record which resident wrapper a decode of ``module`` reaches."""
    calls = []
    for kind, name in (("compressed", f"compressed_{schedule}_decode"),
                       ("message", f"resident_{schedule}_decode")):
        real = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, real=real, kind=kind: calls.append(kind) or real(*a),
        )
    return calls


@pytest.mark.parametrize(
    "decoder,form",
    [
        ("HLMinsumf32", "compressed"),
        ("HLNormminsumf32", "compressed"),
        ("HLMinsumbf16", "message"),
        ("HLNormminsumbf16", "message"),
        ("Minsumf32", "compressed"),
        ("Normminsumf32", "compressed"),
        ("Minsumbf16", "message"),
        ("Normminsumbf16", "message"),
    ],
)
def test_resident_routing_by_storage_type(monkeypatch, decoder, form):
    """On the resident path the f32 names reach the compressed wrappers and
    the bf16 names the message wrappers, as the JAX package routes them at
    the flagship shape."""
    layered = decoder.startswith("HL")
    module = lifted_layered if layered else lifted_flooding
    calls = _routed(monkeypatch, module, "layered" if layered else "flooding")
    _, tlg, x = _inputs()
    decode = module.lifted_layered_decode if layered else module.lifted_flooding_decode
    out = decode(tlg, make_arithmetic(decoder)[1], torch.from_numpy(x[:8]), 2)
    assert calls == [form]
    assert out["codeword"].shape == (8, tlg.n)


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("rule", ["i8", "other f32"])
def test_resident_routing_by_rule(monkeypatch, schedule, rule):
    """Only min-sum with f32 storage keeps the compressed state: an i8 rule
    and a float rule of another family, f32 storage and all, reach the
    message kernels (the JAX package's ``isinstance(rule, MinSumRule)``),
    and the stub decodes there as Minsumf32 decodes through the compressed
    state."""
    module = lifted_layered if schedule == "layered" else lifted_flooding
    prefix = "HL" if schedule == "layered" else ""
    decode = getattr(module, f"lifted_{schedule}_decode")
    _, tlg, x = _inputs()
    llr = torch.from_numpy(x[:16])
    if rule == "i8":
        arith = make_arithmetic(prefix + "Minstarapproxi8")[1]
        assert not takes_compressed_state(fused_bp2.rule_for(arith))
    else:
        arith = make_arithmetic(prefix + "Minsumf32")[1]
        expect = decode(tlg, arith, llr, 4)
        stub = _OtherF32Rule()
        assert stub.storage_dtype == torch.float32 and not takes_compressed_state(stub)
        monkeypatch.setattr(module, "rule_for", lambda arithmetic: stub)
    calls = _routed(monkeypatch, module, schedule)
    out = decode(tlg, arith, llr, 4)
    assert calls == ["message"]
    if rule != "i8":
        for key in ("codeword", "iterations", "success"):
            assert torch.equal(out[key], expect[key]), key
