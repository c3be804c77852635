"""The port's plane-gather flooding path (``ops/plane_gather.py``,
``decoder/lifted_flooding.plane_flooding_decode``) and the decoders' routing
to the torch paths, against the JAX package on the CPU.

* ``plane_gather`` equals the JAX package's on seeded f32, bf16 and int8
  planes;
* ``plane_flooding_decode`` equals JAX ``lifted_flooding_decode``
  (``fused=False``, the plane-gather path) on 5G BG2 z=16, DVB-S2
  R1_4short (the staircase's missing lane) and CCSDS C2 (Z = 511), for a
  min-sum f32, a bf16, an i8 and a float name: success, iterations and
  codewords bit for bit, the float name with torch's transcendentals on
  the JAX side (``torch_parity.torch_transcendentals``), as the float tests
  hold the float rules;
* an arithmetic without a kernel rule, the JAX example's offset min-sum
  registered in both registries, decodes through ``Decoder`` in both
  schedules on a lifted code and equals the JAX ``Decoder``;
* a lifted graph with a check wider than an i8 rule's kernels take falls
  back, with a warning for flooding and silently for layered, as the JAX
  package does, and equals the JAX decode."""

import functools
import importlib.util
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu import sparse as jax_sparse
from ldpc_toolbox_tpu.decoder import Decoder as JaxDecoder
from ldpc_toolbox_tpu.decoder import arithmetic as jax_arithmetic
from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder import lifted as jax_lifted
from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode as jax_flooding
from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode as jax_layered
from ldpc_toolbox_tpu.ops.plane_gather import plane_gather as jax_plane_gather
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch import sparse as torch_sparse
from ldpc_toolbox_torch.decoder import DECODER_IMPLEMENTATIONS, Decoder
from ldpc_toolbox_torch.decoder import lifted as torch_lifted
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted_flooding import (
    lifted_flooding_decode,
    plane_flooding_decode,
)
from ldpc_toolbox_torch.decoder.lifted_layered import kernel_fallback, lifted_layered_decode
from ldpc_toolbox_torch.ops.plane_gather import plane_gather

from torch_parity import (
    assert_same_decode,
    code_objects,
    lifted_graphs,
    llrs,
    mixed_llrs,
    torch_transcendentals,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plane_gather_matches_jax(dtype):
    rng = np.random.default_rng(4)
    P, Z, B, G, d = 6, 9, 5, 3, 4
    src = rng.integers(-100, 100, (P, Z, B)).astype(np.float32) / 4
    planes = rng.integers(0, P, (G, d))
    shifts = rng.integers(0, Z, (G, d))
    if dtype == "int8":
        src = src.astype(np.int8)
    jsrc, tsrc = jnp.asarray(src), torch.from_numpy(src)
    if dtype == "bfloat16":
        jsrc, tsrc = jsrc.astype(jnp.bfloat16), tsrc.to(torch.bfloat16)
    jout = jax_plane_gather(jsrc, planes, shifts)
    out = plane_gather(tsrc, planes, shifts)
    assert out.shape == (G, d, Z, B) and out.dtype == tsrc.dtype
    np.testing.assert_array_equal(np.asarray(jout.astype(jnp.float32)), out.float().numpy())
    # the definition: out[g, t, l] = src[planes[g, t], (l - shifts[g, t]) % Z]
    g, t, lane = 2, 1, 3
    assert torch.equal(out[g, t, lane], tsrc[planes[g, t], (lane - shifts[g, t]) % Z])


#: plane-path cases, code -> (batch, noise sigmas of the first and last
#: frame, iterations): each a mix of converged and failed frames, frame 0
#: a codeword already (iteration 0)
CASES = {"bg2z16": (48, (1.1, 1.5), 8), "R1_4short": (24, (0.7, 0.9), 6),
         "ccsds-c2": (12, (0.44, 0.52), 6)}
NAMES = ["Minsumf32", "Minsumbf16", "Aminstari8JonesPartialHardLimitDeg1Clip", "Phif32"]
TRANSCENDENTALS = ("exp", "expm1", "log", "log1p", "tanh", "arctanh")


@functools.cache
def _case(code):
    jlg, tlg = lifted_graphs(code)
    batch, sigma, _ = CASES[code]
    return jlg, tlg, mixed_llrs(tlg.n, batch, seed=6, sigmas=sigma)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("code", list(CASES))
def test_plane_flooding_decode_matches_jax(code, name, monkeypatch):
    jlg, tlg, x = _case(code)
    iters = CASES[code][2]
    if name.startswith("Phi"):
        torch_transcendentals(monkeypatch, jax_arithmetic, TRANSCENDENTALS)
    jout = jax_flooding(jlg, jax_factory.make_arithmetic(name)[1], jnp.asarray(x), iters)
    out = plane_flooding_decode(tlg, make_arithmetic(name)[1], torch.from_numpy(x), iters)
    assert out["codeword"].dtype == torch.uint8 and out["iterations"].dtype == torch.int32
    assert_same_decode(jout, out)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["Offsetminsumf32", "HLOffsetminsumf32"])
def test_external_arithmetic_decodes_lifted_codes(name, monkeypatch):
    """The examples' offset min-sum, registered in both packages, through
    ``Decoder`` on 5G BG2 z=16: no kernel rule, so the port takes its torch
    path of the schedule (no warning: nothing is refused), and equals the
    JAX ``Decoder`` (on the CPU its plane-gather and jnp layered paths)."""
    jax_example = _load("examples/external_decoder_ber.py", "jax_external_example")
    example = _load("examples/external_decoder_ber_torch.py", "torch_external_example")
    schedule = "layered" if name.startswith("HL") else "flooding"
    monkeypatch.setitem(jax_factory.DECODER_IMPLEMENTATIONS, name,
                        (schedule, lambda: jax_example.OffsetMinSum()))
    monkeypatch.setitem(DECODER_IMPLEMENTATIONS, name,
                        (schedule, lambda: example.OffsetMinSum()))
    x = llrs(16 * 52, 48, 1.4 if schedule == "layered" else 1.3, seed=7)
    jout = JaxDecoder(code_objects("bg2z16", jax_codes), name).decode_batch(x, 8)
    dec = Decoder(code_objects("bg2z16", torch_codes), name, device="cpu")
    assert dec.schedule == schedule and kernel_fallback(dec.lifted, dec.arithmetic)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = dec.decode_batch(torch.from_numpy(x), 8)
    assert_same_decode(jout, out)


def _one_wide_check(sparse, lifted, degree):
    """A graph of Z = 1 whose first check has ``degree`` variables, and
    checks of degree 4 that give every variable a second edge."""
    n = degree
    h = sparse.SparseMatrix(1 + n // 4 + (n % 4 > 0), n)
    h.insert_row(0, range(n))
    for r in range(0, n, 4):
        h.insert_row(1 + r // 4, range(r, min(r + 4, n)))
    rows = h.num_rows
    return lifted.LiftedGraph.from_sparse(h, lambda v: (v, 0), lambda c: (c, 0), 1, n, rows)


@pytest.mark.parametrize("name", ["Minstarapproxi8", "HLMinstarapproxi8"])
def test_wide_check_falls_back_and_matches_jax(name):
    """A check of degree 33, above the i8 kernels' 32: the decoders take the
    plane path (flooding, with a warning naming the reason) or the plain
    layered path (silently), as the JAX package does on the same graph,
    and give its output; a graph of degree 32 stays on the kernels."""
    jlg = _one_wide_check(jax_sparse, jax_lifted, 33)
    tlg = _one_wide_check(torch_sparse, torch_lifted, 33)
    x = llrs(33, 64, 0.9, seed=3)
    _, ta = make_arithmetic(name)
    _, ja = jax_factory.make_arithmetic(name)
    assert "check degree 33 above 32" in kernel_fallback(tlg, ta)
    assert kernel_fallback(_one_wide_check(torch_sparse, torch_lifted, 32), ta) is None
    if name.startswith("HL"):
        jout = jax_layered(jlg, ja, jnp.asarray(x), 6)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out = lifted_layered_decode(tlg, ta, torch.from_numpy(x), 6)
    else:
        jout = jax_flooding(jlg, ja, jnp.asarray(x), 6)
        with pytest.warns(UserWarning, match="check degree 33 above 32"):
            out = lifted_flooding_decode(tlg, ta, torch.from_numpy(x), 6)
    assert_same_decode(jout, out)


def test_multi_lane_gap_falls_back():
    """A circulant missing more than one lane is beyond the kernels'
    layout: ``kernel_fallback`` names it for every name."""
    import dataclasses

    _, tlg = lifted_graphs("R1_4short")
    vm, cm, lanes_c, lanes_v = tlg.missing[0]
    wide = dataclasses.replace(tlg, missing=((vm, cm, np.array([0, 1]), np.array([0, 1])),))
    for name in ("Minsumbf16", "HLMinsumf32", "Phif64"):
        assert kernel_fallback(tlg, make_arithmetic(name)[1]) is None
        assert kernel_fallback(wide, make_arithmetic(name)[1]) == (
            "a circulant misses more than one lane")
