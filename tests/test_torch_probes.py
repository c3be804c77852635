"""The probes of ``ldpc_toolbox_torch/probes`` against the JAX package's TPU
probes (``tools/prof_*.py``) on the CPU: the same seeded numpy inputs go
through each tool's own function, its Pallas kernel in interpret mode
(``pallas_call`` patched), and through the port's plain version, which the
port's wrappers run on a CPU tensor. The CUDA kernels are held against the
plain versions in test_torch_cuda.py.

The tools run at small sizes set through their own constants. Every case
is bit for bit, ``fma``'s too: XLA's CPU jit may contract its multiply and
add into one FMA, but from the tool's inputs in [0.4, 0.6) one rounding
and two agree (see ``vpu_peak``).
``vpu_peak`` runs at K = 1: within a grid step of K rounds XLA's CPU jit
reassociates the chained additions of constants (x + c + c + c + c becomes
x + (c + c) + (c + c), 1.9e-6 from the rounds in turn at K = 4), which
nothing can do across grid steps. ``prof_roll.py`` measures at import, so
its text is run up to its measuring loop with its sizes line and P
replaced; ``pallas_stream`` only prints, so its output is taken from the
tool's ``timeit``. The tools enable JAX's compile cache at import: it goes
to a temporary directory, and the settings are restored afterwards."""

import functools
import importlib
import pathlib
import sys

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_torch.decoder import lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops.fused_layered import fused_layered_iteration_reference
from ldpc_toolbox_torch.probes import copybw, layered_variants, roll, v2, vpu_peak

from torch_parity import as_torch, lifted_graphs

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ("prof_copybw", "prof_vpu_peak", "prof_v2", "prof_layered_variants")
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """The tools' modules, imported afresh with Pallas in interpret mode
    and the compile cache in a temporary directory; undone afterwards."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LDPC_TOOLBOX_TPU_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(sys, "path", [str(REPO / "tools"), *sys.path])
        for name in TOOLS:
            sys.modules.pop(name, None)
        yield {name: importlib.import_module(name) for name in TOOLS}
        for name in TOOLS:
            sys.modules.pop(name, None)
    for k, v in saved.items():
        jax.config.update(k, v)


def _same(jax_out, port_out):
    np.testing.assert_array_equal(np.asarray(jnp.asarray(jax_out).astype(jnp.float32)),
                                  port_out.float().numpy())


class _SeededZeros:
    """``jax.numpy`` but for ``zeros``, which gives the seeded array."""

    def __init__(self, data):
        self.data = data

    def __getattr__(self, name):
        return getattr(jnp, name)

    def zeros(self, shape, dtype):
        assert tuple(shape) == self.data.shape
        return jnp.asarray(self.data, dtype)


#: (G, P, Z, Bt) slabs: the first 3 of the kernel's blocks in bf16 (6 in
#: f32), the second 4.69 blocks in bf16 and 9.38 in f32
COPY_SHAPES = [(3, 2, 16, 128), (3, 5, 20, 64)]


@pytest.mark.parametrize("shape", COPY_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_copy_stream_matches_the_tool(tools, monkeypatch, dtype, shape):
    m = tools["prof_copybw"]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 100
    if shape != COPY_SHAPES[0]:
        assert x.size * getattr(torch, dtype).itemsize % copybw.BLOCK_BYTES
    outs = []

    def timeit(fn, *args, reps=10):
        outs.append(fn(*args))
        return 1.0

    monkeypatch.setattr(m, "jnp", _SeededZeros(x))
    monkeypatch.setattr(m, "timeit", timeit)
    G, P, Z, Bt = shape
    m.pallas_stream(P, Z, Bt, G, getattr(jnp, dtype))
    port = copybw.stream_slabs(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert port.dtype == getattr(torch, dtype) and port.shape == x.shape
    _same(outs[0], port)


@pytest.mark.parametrize("mode", vpu_peak.MODES)
def test_alu_chain_matches_the_tool(tools, monkeypatch, mode):
    m = tools["prof_vpu_peak"]
    monkeypatch.setattr(m, "R", 12)
    monkeypatch.setattr(m, "K", 1)
    a = np.random.default_rng(0).uniform(0.4, 0.6, (m.Z, m.B)).astype(np.float32)
    got = np.asarray(m.make(mode)(jnp.asarray(a), jnp.float32(0.0))[0])
    port = vpu_peak.alu_chain(torch.from_numpy(a)[None], mode, 12)[0].numpy()
    np.testing.assert_array_equal(got, port)
    assert not np.array_equal(port, a)


@pytest.mark.parametrize("z", sorted(vpu_peak.ROLL_LANES))
def test_roll_lanes_map_is_torch_roll(z):
    """roll's kernel layout (a column in the registers of T lanes, lane t
    rows t b .. t b + b - 1) and its index map ``roll_source``, run in the
    kernel's order: the values it shuffles read first, then the rest inside
    a lane from the top register down, in place. Every round equals
    ``torch.roll(x, 37, dims=1)`` bit for bit, and every value moves."""
    t_lanes = vpu_peak.ROLL_LANES[z]
    b = z // t_lanes
    q, m = divmod(37 % z, b)
    x = torch.arange(2 * z * 3, dtype=torch.float32).reshape(2, z, 3)
    regs = [[x[:, t * b + i] for i in range(b)] for t in range(t_lanes)]
    src = {(t, i): vpu_peak.roll_source(z, t_lanes, t, i)
           for t in range(t_lanes) for i in range(b)}
    # the kernel shuffles rows i < m, and every row where q > 0
    shuffled = {key for key in src if key[1] < m or q}
    for _ in range(3):
        got = {key: regs[lt][li] for key, (lt, li) in src.items() if key in shuffled}
        for t in range(t_lanes):
            for i in reversed(range(b)):
                if (t, i) not in shuffled:
                    lt, li = src[t, i]
                    assert lt == t and li < i  # in the lane, not yet written
                    got[t, i] = regs[t][li]
                regs[t][i] = got[t, i]
        x = torch.roll(x, 37, dims=1)
        got = torch.stack([r for lane in regs for r in lane], dim=1)
        assert torch.equal(got, x)
        assert all(src[key] != key for key in src)


@functools.cache
def _roll_tool():
    """``prof_roll.py``'s definitions (up to its measuring loop) at small
    sizes, in a namespace of their own."""
    text = (REPO / "tools/prof_roll.py").read_text()
    text = text.replace("Z, align, Bt, G, d, nbt = 360, 16, 128, 90, 7, 4",
                        "Z, align, Bt, G, d, nbt = 24, 16, 8, 2, 7, 1")
    text = text.replace("P = 630", "P = 10")
    head = text[: text.index("for mode in")]
    assert "24, 16, 8, 2, 7, 1" in head and "P = 10" in head
    ns = {"__name__": "prof_roll"}
    exec(compile(head, "tools/prof_roll.py", "exec"), ns)
    return ns


@pytest.mark.parametrize("mode", roll.MODES)
def test_rotated_gather_matches_the_tool(tools, mode):
    ns = _roll_tool()
    src, planes, shifts = roll.inputs(seed=0, device="cpu", nbt=1, p=10, z=24, bt=8, g=2)
    # both aligned window starts, and 11 of the 16 offsets in a window
    starts = [24 - s for s in shifts.tolist()]
    assert {s // 16 for s in starts} == {0, 1} and len({s % 16 for s in starts}) == 11
    ns.update(src=jnp.asarray(src.float().numpy(), jnp.bfloat16), planes=planes.numpy(),
              shifts=shifts.numpy())
    got = ns["make"](mode)()
    port = roll.rotated_gather(src, planes, shifts, mode)
    assert port.shape == (1, 2, 24, 8)
    _same(got, port)


@pytest.mark.parametrize("mode,z,b,bt", [(mode, 16, 16, 8) for mode in v2.MODES]
                         # the copy over 6.56 of the kernel's blocks
                         + [("copy", 40, 32, 16)])
def test_minsum_writes_match_the_tool(tools, monkeypatch, mode, z, b, bt):
    m = tools["prof_v2"]
    g, d, seed = 3, 7, 5
    for name, value in dict(Z=z, G=g, d=d, B=b, P=g * d).items():
        monkeypatch.setattr(m, name, value)
    rng = np.random.default_rng(seed)
    monkeypatch.setattr(m, "rng", rng)
    monkeypatch.setattr(m, "dest", rng.permutation(g * d).astype(np.int32))
    monkeypatch.setattr(m, "shifts", rng.integers(0, z, g * d).astype(np.int32))
    src, dest, shifts = v2.inputs(bt, seed=seed, device="cpu", b=b, g=g, d=d, z=z)
    np.testing.assert_array_equal(dest.numpy(), m.dest)
    if z == 40:
        assert src.nbytes % copybw.BLOCK_BYTES
    fn, _ = m.make(mode, bt)
    port = v2.run(mode, src, dest, shifts)
    _same(fn(), port)
    if mode != "copy":
        assert (port.float().abs() < 1e30).all()


@functools.cache
def _bg2_case():
    """5G BG2 z=16 at one JAX tile of 128 frames: the two packages'
    graphs and the seeded f32 Qv and nonzero bf16-valued Rcv planes."""
    jlg, tlg = lifted_graphs("bg2z16")
    layout = lifted_layered.device_layout(tlg, "cpu")
    rng = np.random.default_rng(7)
    qv = rng.standard_normal((layout.VG, layout.Z, 128)).astype(np.float32) * 4
    rcv = rng.standard_normal((layout.E, layout.Z, 128)).astype(np.float32)
    rcv = torch.from_numpy(rcv).to(torch.bfloat16).float().numpy()
    return jlg, tlg, qv, rcv


def _port_tiles(planes):
    """(P, Z, B) planes -> the port's (B / 4, P, Z, 4) tiles."""
    P, Z, B = planes.shape
    return as_torch(planes.reshape(P, Z, B // 4, 4).transpose(2, 0, 1, 3))


def _planes(tiles):
    t = tiles.float().numpy()
    return t.transpose(1, 2, 0, 3).reshape(t.shape[1], t.shape[2], -1)


@functools.cache
def _port_sweep(variant):
    _, tlg, qv, rcv = _bg2_case()
    layout = lifted_layered.device_layout(tlg, "cpu")
    rule = lifted_layered.rule_for(make_arithmetic("HLMinsumbf16")[1])
    qv_t, rcv_t = _port_tiles(qv), _port_tiles(rcv).to(torch.bfloat16)
    out = layered_variants.layered_sweep_parts(qv_t, rcv_t, layout, rule, variant)
    assert out[0] is qv_t and out[1] is rcv_t  # in place
    return out


_TOOL_KW = {"full": {}, "normw": dict(rmw=False), "noroll": dict(rolls=False),
            "norule": dict(use_rule=False), "dmaonly": dict(compute_on=False)}


@pytest.mark.parametrize("variant", list(layered_variants.VARIANTS))
def test_layered_variant_matches_the_tool(tools, monkeypatch, variant):
    m = tools["prof_layered_variants"]
    jlg, _, qv, rcv = _bg2_case()
    monkeypatch.setattr(m, "BATCH", m.BT)
    layout = m.build_fused_layout(jlg)
    arith = jax_factory.make_arithmetic("HLMinsumbf16")[1]
    rule = m.rule_for(arith)
    it = m.make_iteration(layout, rule, rule.qv_dtype(arith), **_TOOL_KW[variant])
    jqv, jrcv = it(jnp.asarray(qv[None]), jnp.asarray(rcv[None], rule.storage_dtype))
    qv_t, rcv_t, bits = _port_sweep(variant)
    np.testing.assert_array_equal(np.asarray(jqv[0]), _planes(qv_t))
    np.testing.assert_array_equal(np.asarray(jrcv[0].astype(jnp.float32)), _planes(rcv_t))
    np.testing.assert_array_equal(_planes(bits), _planes(qv_t) <= 0)
    moved = not np.array_equal(_planes(rcv_t), rcv)
    assert moved == (variant != "dmaonly")
    assert np.array_equal(_planes(qv_t), qv) == (variant in ("normw", "dmaonly"))


def test_full_variant_is_the_sweep():
    """``full`` is the port's streaming sweep: its plain version equals
    ``fused_layered_iteration_reference`` bit for bit."""
    _, tlg, qv, rcv = _bg2_case()
    layout = lifted_layered.device_layout(tlg, "cpu")
    rule = lifted_layered.rule_for(make_arithmetic("HLMinsumbf16")[1])
    want = fused_layered_iteration_reference(_port_tiles(qv), _port_tiles(rcv).to(torch.bfloat16),
                                             layout, rule)
    for a, b in zip(_port_sweep("full"), want):
        assert torch.equal(a, b)


def test_plain_versions_refuse_unknown_modes():
    """A CPU tensor goes to the plain version, which raises on a mode or
    variant the tool does not have."""
    with pytest.raises(ValueError, match="mode"):
        vpu_peak.alu_chain(torch.zeros((1, 8, 32)), "mul", 1)
    with pytest.raises(ValueError, match="mode"):
        roll.rotated_gather(*roll.inputs(device="cpu", nbt=1, p=2, z=8, bt=8, g=1), "shift")
    with pytest.raises(ValueError, match="mode"):
        v2.minsum_planes(torch.zeros((1, 1, 2, 8, 8), dtype=torch.bfloat16), "scatter")
    with pytest.raises(ValueError, match="variant"):
        layered_variants.layered_sweep_parts(torch.zeros(1), None, None, None, "half")
