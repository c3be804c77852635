"""The port's lifted graph and flat layout against the JAX package's, the
port's copies of the JAX package's numpy modules against the originals,
the device tables both packages decode on, and the port's freedom from jax
and from the JAX package."""

import dataclasses
import gc
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu import gf2 as jax_gf2
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_tpu.ops import resident_compressed as jax_compressed
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch import gf2
from ldpc_toolbox_torch.convert import layout_to_device
from ldpc_toolbox_torch.decoder import lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops import fused_bp2
from ldpc_toolbox_torch.ops.resident_compressed import shared_ints
from ldpc_toolbox_torch.ops.resident_layered import (
    I8_LAYERED_THREADS,
    I8_MAX_CHECK_DEGREE,
    LANE_THREADS,
    LAYERED_TABLES,
    MAX_SHARED_BYTES,
    park_dtype,
    parks_in_device_memory,
    resident_layered_decode,
)

from torch_parity import CODES, as_torch, lifted_graphs, llrs, parity_check

REPO = pathlib.Path(__file__).resolve().parent.parent


def _assert_equal_fields(a, b, names):
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=name)
            assert va.dtype == vb.dtype, name
        elif name == "missing":
            assert len(va) == len(vb)
            for ma, mb in zip(va, vb):
                assert ma[:2] == mb[:2]
                np.testing.assert_array_equal(ma[2], mb[2])
                np.testing.assert_array_equal(ma[3], mb[3])
        elif name in ("chk_buckets", "var_buckets"):
            assert len(va) == len(vb)
            for ba, bb in zip(va, vb):
                _assert_equal_fields(
                    ba, bb, [f.name for f in dataclasses.fields(ba)]
                )
        elif name in ("chk_meta", "var_meta"):
            assert [dataclasses.astuple(m) for m in va] == [
                dataclasses.astuple(m) for m in vb
            ], name
        else:
            assert va == vb, name


@pytest.mark.parametrize("code", CODES)
def test_lifted_graph_and_layout_match_jax(code):
    jlg, tlg = lifted_graphs(code)
    _assert_equal_fields(jlg, tlg, [f.name for f in dataclasses.fields(jlg)])
    jl = jax_fused_bp2.build_fused_layout(jlg)
    tl = fused_bp2.build_fused_layout(tlg)
    _assert_equal_fields(jl, tl, [f.name for f in dataclasses.fields(tl)])
    assert tl.max_chk_degree == jl.max_chk_degree


@pytest.mark.parametrize("code", CODES)
def test_recon_tables_match_jax(code):
    """The port's copy of the compressed flooding decode's reconstruction
    tables equals the JAX original, and the device layout carries them."""
    jlg, tlg = lifted_graphs(code)
    expect = jax_compressed._var_recon_tables(jax_fused_bp2.build_fused_layout(jlg))
    tables = fused_bp2.var_recon_tables(fused_bp2.build_fused_layout(tlg))
    layout = lifted_layered.device_layout(tlg, "cpu")
    for name, a, b in zip(("plane", "group", "slot", "rot"), expect, tables):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert b.dtype == np.int32
        np.testing.assert_array_equal(getattr(layout, f"rec_{name}").numpy(), b)


@pytest.mark.parametrize("code", CODES)
def test_compressed_kernels_shared_memory(code):
    """The shared memory of a compressed kernel's block, held against the
    device layout: its tables hold ``chk_cs`` and ``var_cs`` with an end
    entry, a repeat flag a check group and eight tables an edge, in whole
    16-byte rows after the 8 control words; the layered park adds max
    degree x Z x 4 floats and fits beside them on every test code but
    CCSDS C2, whose park goes to device memory."""
    _, tlg = lifted_graphs(code)
    layout = lifted_layered.device_layout(tlg, "cpu")
    assert layout.chk_cs.numel() == layout.CG and layout.var_cs.numel() == layout.VG
    for name in ("syn_vg", "syn_rot", "chk_rot", "syn_mask",
                 "rec_plane", "rec_group", "rec_slot", "rec_rot"):
        assert getattr(layout, name).numel() == layout.E, name
    tables = shared_ints(layout, False) - 8
    need = (layout.CG + 1) + (layout.VG + 1) + layout.CG + 8 * layout.E
    assert tables % 4 == 0 and need <= tables < need + 4
    park = layout.max_chk_degree * layout.Z * fused_bp2.BT
    assert shared_ints(layout, True) == shared_ints(layout, False) + park
    assert 4 * shared_ints(layout, False) <= MAX_SHARED_BYTES
    fits = 4 * shared_ints(layout, True) <= MAX_SHARED_BYTES
    assert fits == (code != "ccsds-c2")


@pytest.mark.parametrize("code", CODES)
def test_message_kernels_shared_memory(code):
    """The message kernels (resident layered and flooding) copy the
    compressed kernels' tables, so one ``shared_ints`` gives the shared
    memory of all four: the flooding kernels' block holds the tables only,
    the layered kernels' the tables and their park, except on CCSDS C2,
    whose park goes to device memory. Held against the device layout, the
    flooding kernel's one message array is consistent: the cell var-major
    edge p reads at variable lane w through ``rec_plane`` and ``rec_rot``
    is the v2c cell the phase kernels write (``var_dest``, w + ``var_rot``),
    and its missing lane is ``var_omask``. Two blocks of a layered kernel
    fit an SM's shared memory with their tables and park, as their launch
    bounds count on."""
    _, tlg = lifted_graphs(code)
    layout = lifted_layered.device_layout(tlg, "cpu")
    for name in LAYERED_TABLES:
        want = {"chk_cs": layout.CG, "var_cs": layout.VG}.get(name, layout.E)
        assert getattr(layout, name).numel() == want, name
    assert 4 * shared_ints(layout, False) <= MAX_SHARED_BYTES
    device_park = parks_in_device_memory(layout)
    assert device_park == (code == "ccsds-c2")
    assert device_park == (4 * shared_ints(layout, True) > MAX_SHARED_BYTES)
    # an H100 SM: 233,472 bytes of shared memory, 1 KiB of it reserved a block
    assert 2 * (4 * shared_ints(layout, not device_park) + 1024) <= 233_472
    Z = layout.Z
    w = torch.arange(Z)
    plane = layout.rec_plane.long()
    assert torch.equal(plane, layout.var_dest.long())
    cell = (w[None, :] - layout.rec_rot.long()[:, None]) % Z
    assert torch.equal(cell, (w[None, :] + layout.var_rot.long()[:, None]) % Z)
    assert torch.equal(layout.syn_mask[plane], layout.var_omask)


def test_i8_kernel_constants_match_the_rules():
    """The i8 kernels' compiled-in correction table (``csrc/i8.cuh``, read
    from the source) is the port's ``_i8_thresholds()``, which equals the
    JAX package's; their family kinds, variant flags and degree cap are the
    wrappers'."""
    src = (REPO / "ldpc_toolbox_torch" / "csrc" / "i8.cuh").read_text()
    steps = re.search(r"using I8Correction = Steps<([\d,\s]+)>;", src)
    assert steps, "the correction table's steps are not in csrc/i8.cuh"
    compiled = [int(v) for v in steps.group(1).split(",")]
    assert compiled == fused_bp2._i8_thresholds() == jax_fused_bp2._i8_thresholds()

    def constant(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    for name, kind in (("Minstarapproxi8", "kMinstarApprox"), ("Aminstari8", "kAminstar")):
        assert fused_bp2.rule_for(make_arithmetic(name)[1]).kind == constant(kind)
    for suffix, flag in (("PartialHardLimit", "kPartialHardLimit"), ("Jones", "kJones"),
                         ("Deg1Clip", "kDeg1Clip")):
        rule = fused_bp2.rule_for(make_arithmetic("Aminstari8" + suffix)[1])
        assert rule.flags == constant(flag), suffix
    assert constant("kI8MaxDegree") == I8_MAX_CHECK_DEGREE


def test_float_kernel_constants_match_the_rules():
    """The float instances' rule kinds and degree caps (``csrc/
    float_rules.cuh``, read from the source) are the wrappers': kinds 0 to
    3 for Phi, Tanh, MinstarApprox and Aminstar, the cap 64 (the signs'
    64 bits) and MinstarApprox's 32; the rule code's constants are the
    plain rules' (phi's floor 1e-30 and series bound 2^-5)."""
    src = (REPO / "ldpc_toolbox_torch" / "csrc" / "float_rules.cuh").read_text()

    def constant(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    kinds = {"Phif32": "kPhiRule", "Tanhf64": "kTanhRule",
             "Minstarapproxf32": "kMinstarApproxRule", "Aminstarf64": "kAminstarRule"}
    for name, kind in kinds.items():
        assert fused_bp2.rule_for(make_arithmetic(name)[1]).kind == constant(kind), name
    assert constant("kFloatMaxDegree") == fused_bp2.MAX_CHECK_DEGREE == 64
    rule = fused_bp2.rule_for(make_arithmetic("Minstarapproxf64")[1])
    assert constant("kMinstarApproxMaxDegree") == rule.max_check_degree == I8_MAX_CHECK_DEGREE
    assert "x = max_of(x, T(1e-30));" in src and fused_bp2.PhiRule.MIN_X == 1e-30
    assert "if (x < T(0.03125))" in src


def test_f64_flooding_units_match_the_wrappers():
    """The flooding kernels' work units (``csrc/lanes.cuh`` Units and
    ``csrc/float_rules.cuh`` FloatRule's FloodUnits, read from the source):
    the f64 float rules give a thread one frame of a lane at the block the
    wrappers pass them (``F64_UNIT_THREADS``), two blocks an SM at 64
    registers; the other float rules and min-sum a lane's four frames at
    the lane kernels' 256 (the i8 rules': test_i8_units_match_the_wrappers)."""
    csrc = REPO / "ldpc_toolbox_torch" / "csrc"
    units = re.search(r"using FloodUnits = std::conditional_t<std::is_same_v<T, double>, "
                      r"Units<(\d+), (\d+)>, Units<>>;", (csrc / "float_rules.cuh").read_text())
    assert units, "FloatRule's FloodUnits is not in csrc/float_rules.cuh"
    assert (int(units[1]), int(units[2])) == (1, fused_bp2.F64_UNIT_THREADS)
    lanes = (csrc / "lanes.cuh").read_text()
    assert "template <int F = kBt, int Threads = kThreads>\nstruct Units {" in lanes
    assert int(re.search(r"constexpr int kThreads = (\d+);", lanes)[1]) == LANE_THREADS
    assert LANE_THREADS == fused_bp2.PHASE_THREADS
    assert 65536 // (2 * fused_bp2.F64_UNIT_THREADS) == 64
    for name, threads in (("Phif64", fused_bp2.F64_UNIT_THREADS), ("Aminstarf64", 512),
                          ("Phif32", LANE_THREADS), ("Minstarapproxf32", 256)):
        rule = fused_bp2.rule_for(make_arithmetic(name)[1])
        assert fused_bp2.unit_threads(rule, LANE_THREADS) == threads, name
    # a layered name's rule floods as its flooding name's does: the f32
    # float rules' frame pairs are the resident layered kernel's alone
    for name, threads in (("HLPhif32", LANE_THREADS), ("HLPhif64", fused_bp2.F64_UNIT_THREADS)):
        rule = fused_bp2.rule_for(make_arithmetic(name)[1])
        assert fused_bp2.unit_threads(rule, LANE_THREADS) == threads, name


def test_f32_layered_units_match_the_wrappers():
    """The resident layered kernel's check units (``csrc/float_rules.cuh``
    FloatRule's LayeredUnits over ``csrc/lanes.cuh`` Units, read from the
    source): the f32 float rules give a check lane's thread a frame pair of
    a lane, so the flagship's check group of Z = 360 lanes takes three
    passes, at Units' block, the lane kernels' that the wrappers pass
    (``LANE_THREADS``; the kernel refuses a larger one), two blocks an SM at
    128 registers; the f64 float rules and min-sum keep a lane's four
    frames (the i8 rules': test_i8_units_match_the_wrappers)."""
    csrc = REPO / "ldpc_toolbox_torch" / "csrc"
    units = re.search(r"using LayeredUnits = std::conditional_t<std::is_same_v<T, float>, "
                      r"Units<(\d+)>, Units<>>;", (csrc / "float_rules.cuh").read_text())
    assert units, "FloatRule's LayeredUnits is not in csrc/float_rules.cuh"
    frames = int(units[1])
    assert frames == 2
    lanes = (csrc / "lanes.cuh").read_text()
    assert "template <int F = kBt, int Threads = kThreads>\nstruct Units {" in lanes
    assert int(re.search(r"constexpr int kThreads = (\d+);", lanes)[1]) == LANE_THREADS
    assert 65536 // (2 * LANE_THREADS) == 128
    assert -(-360 * fused_bp2.BT // (frames * LANE_THREADS)) == 3
    assert "  using LayeredUnits = Units<>;\n" in (csrc / "message_kernels.cuh").read_text()


def test_i8_units_match_the_wrappers():
    """The i8 rules' work units (``csrc/i8.cuh`` I8Rule's FloodUnits and
    LayeredUnits, read from the source): a lane's four frames a thread, at
    the blocks the wrappers pass (``I8_FLOODING_THREADS`` for the flooding
    kernels, resident and phases, of every i8 name; ``I8_LAYERED_THREADS``
    for the resident layered kernel), two blocks an SM at 64 and 85
    registers; a flagship check group of Z = 360 lanes in one pass of the
    layered block."""
    src = (REPO / "ldpc_toolbox_torch" / "csrc" / "i8.cuh").read_text()
    flood = re.search(r"  using FloodUnits = Units<kBt, (\d+)>;\n", src)
    layered = re.search(r"  using LayeredUnits = Units<kBt, (\d+)>;\n", src)
    assert flood and layered, "I8Rule's units are not in csrc/i8.cuh"
    assert int(flood[1]) == fused_bp2.I8_FLOODING_THREADS == 512
    assert int(layered[1]) == I8_LAYERED_THREADS == 384
    assert (65536 // (2 * 512), 65536 // (2 * 384)) == (64, 85)
    assert -(-360 // I8_LAYERED_THREADS) == 1
    for name in ("Minstarapproxi8", "Aminstari8JonesDeg1Clip", "HLAminstari8PartialHardLimit"):
        rule = fused_bp2.rule_for(make_arithmetic(name)[1])
        assert fused_bp2.unit_threads(rule, LANE_THREADS) == fused_bp2.I8_FLOODING_THREADS


@pytest.mark.parametrize("code", CODES)
def test_f64_park_shared_memory(code):
    """The f64 layered instances park 8-byte deltas: twice the f32 park's
    words, still beside the tables on every test code but CCSDS C2; the
    wrappers allocate a device park of f64 there."""
    _, tlg = lifted_graphs(code)
    layout = lifted_layered.device_layout(tlg, "cpu")
    park = layout.max_chk_degree * layout.Z * fused_bp2.BT
    assert shared_ints(layout, True, 8) == shared_ints(layout, False) + 2 * park
    assert parks_in_device_memory(layout, 8) == (code == "ccsds-c2")
    f64 = fused_bp2.rule_for(make_arithmetic("HLPhif64")[1])
    assert park_dtype(f64) == torch.float64
    assert park_dtype(fused_bp2.rule_for(make_arithmetic("HLPhif32")[1])) == torch.float32
    assert park_dtype(fused_bp2.rule_for(make_arithmetic("HLAminstari8")[1])) == torch.int32


@pytest.mark.parametrize("code", CODES)
def test_code_copies_match_jax(code):
    """The port's own ``codes`` (with ``sparse``) build the same
    parity-check matrices as the JAX package's."""
    hj, ht = parity_check(code, jax_codes), parity_check(code, torch_codes)
    assert type(ht).__module__ == "ldpc_toolbox_torch.sparse"
    assert (ht.num_rows, ht.num_cols) == (hj.num_rows, hj.num_cols)
    for r in range(hj.num_rows):
        assert ht.row_list(r) == hj.row_list(r), r


def test_gf2_copy_matches_jax():
    """``gauss_reduction`` of the port's ``gf2`` gives the JAX package's
    result on a fixed seeded matrix, and refuses the same singular one."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2, (24, 40)).astype(np.uint8)
    low = np.tril(rng.integers(0, 2, (24, 24)), -1) + np.eye(24, dtype=np.int64)
    up = np.triu(rng.integers(0, 2, (24, 24)), 1) + np.eye(24, dtype=np.int64)
    a[:, :24] = (low @ up) % 2  # an invertible leading block
    expect = jax_gf2.gauss_reduction(a.copy())
    np.testing.assert_array_equal(gf2.gauss_reduction(a.copy()), expect)
    singular = a.copy()
    singular[1] = singular[0]
    with pytest.raises(jax_gf2.NotInvertibleError):
        jax_gf2.gauss_reduction(singular.copy())
    with pytest.raises(gf2.NotInvertibleError):
        gf2.gauss_reduction(singular.copy())


def test_jax_layout_decodes_like_the_ports():
    """layout_to_device accepts the JAX package's layout, and both tables
    decode the same tiles to the same results."""
    jlg, tlg = lifted_graphs("bg2z16")
    tables = [
        layout_to_device(jax_fused_bp2.build_fused_layout(jlg), "cpu"),
        layout_to_device(fused_bp2.build_fused_layout(tlg), "cpu"),
    ]
    for name in (
        "chk_cs", "chk_dest", "chk_rot", "chk_omask", "var_cs", "var_dest",
        "var_rot", "var_omask", "syn_vg", "syn_rot", "syn_mask",
    ):
        a, b = getattr(tables[0], name), getattr(tables[1], name)
        assert a.dtype == torch.int32 and torch.equal(a, b), name
    x = llrs(tlg.n, 64, 1.3, seed=3)
    col = tlg.var_cols[tlg.var_group_order].reshape(-1)
    planes = x.T[col].reshape(tlg.num_var_groups, tlg.Z, 16, 4)
    qv0 = as_torch(planes.transpose(2, 0, 1, 3))
    bits0 = (qv0 <= 0).to(torch.int8)
    rule = fused_bp2.rule_for(make_arithmetic("HLMinsumbf16")[1])
    outs = [resident_layered_decode(qv0, bits0, t, rule, 6) for t in tables]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    conv = outs[0][2]
    assert 0 < int(conv.sum()) < conv.numel()


def test_device_layout_is_built_once_per_graph_and_device():
    """The decode glue builds a graph's tables once per device, equal to
    ``layout_to_device`` of its layout, and drops them with the graph."""
    _, tlg = lifted_graphs("bg2z16")
    tlg = dataclasses.replace(tlg)  # a graph of this test's own
    first = lifted_layered.device_layout(tlg, "cpu")
    assert lifted_layered.device_layout(tlg, torch.device("cpu")) is first
    fresh = layout_to_device(fused_bp2.build_fused_layout(tlg), "cpu")
    for f in dataclasses.fields(first):
        a, b = getattr(first, f.name), getattr(fresh, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    key = (id(tlg), torch.device("cpu"))
    assert key in lifted_layered._LAYOUTS
    del tlg
    gc.collect()
    assert key not in lifted_layered._LAYOUTS


def test_port_never_imports_jax():
    """Importing every module of the port, and everything chip_smoke.py
    imports, leaves jax and every module of the JAX package unimported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ldpc_toolbox_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(sorted(k for k in sys.modules if k.startswith('ldpc_toolbox_torch')))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [k for k in sys.modules if k.startswith('ldpc_toolbox_tpu')]\n"
        "assert not bad, f'the JAX package was imported: {bad}'\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ldpc_toolbox_torch.simulation.ber" in proc.stdout
    assert "ldpc_toolbox_torch.cli" in proc.stdout
    assert "ldpc_toolbox_torch.codes.dvbs2" in proc.stdout
    assert "ldpc_toolbox_torch.decoder.lifted_flooding" in proc.stdout
    for module in ("decoder.compaction", "ops.resident_compressed", "ops.fused_layered",
                   "decoder.layout", "decoder.flooding", "decoder.layered", "systematic",
                   "simulation.puncturing", "simulation.interleaving", "utils.chacha",
                   "utils.rng", "mackay_neal", "peg"):
        assert f"ldpc_toolbox_torch.{module}" in proc.stdout, module
