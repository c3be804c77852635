"""The plain versions of the port's compressed check-state decodes against
the JAX package's compressed kernels (``ops/resident_compressed.py``, run
in interpret mode by setting its ``LDPC_FORCE_COMPRESSED`` switch) and, for
layered, its jnp path (``fused=False``), bit for bit in success,
iterations and codewords; and the decoders' routing by storage type. The
CUDA kernels are held against these plain versions in test_torch_cuda.py.

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
from ldpc_toolbox_torch.ops.resident_compressed import (
    compressed_flooding_decode,
    compressed_layered_decode,
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
    calls = []
    layered = decoder.startswith("HL")
    module = lifted_layered if layered else lifted_flooding
    schedule = "layered" if layered else "flooding"
    names = {
        "compressed": f"compressed_{schedule}_decode",
        "message": f"resident_{schedule}_decode",
    }
    for kind, name in names.items():
        real = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, real=real, kind=kind: calls.append(kind) or real(*a),
        )
    _, tlg, x = _inputs()
    decode = module.lifted_layered_decode if layered else module.lifted_flooding_decode
    out = decode(tlg, make_arithmetic(decoder)[1], torch.from_numpy(x[:8]), 2)
    assert calls == [form]
    assert out["codeword"].shape == (8, tlg.n)
