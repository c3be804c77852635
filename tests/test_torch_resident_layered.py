"""The plain version of the resident layered kernel against the JAX
package's Pallas kernel (interpret mode), the wrapper's CPU dispatch and
launch count, and the kernel build's refusal without a toolkit. The CUDA
kernel itself is held against its plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_tpu.ops import resident_layered as jax_resident
from ldpc_toolbox_torch.convert import layout_to_device
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops import _build, fused_bp2
from ldpc_toolbox_torch.ops.resident_layered import (
    resident_layered_decode,
    resident_layered_decode_reference,
)

from torch_parity import as_torch, lifted_graphs, llrs


def _tiles(lg, x, bt):
    """(B, n) LLRs -> f32 qv0 and int8 raw bits, (nbt, VG, Z, bt) tiles."""
    col = lg.var_cols[lg.var_group_order].reshape(-1)
    B = x.shape[0]
    planes = x.T[col].reshape(lg.num_var_groups, lg.Z, B // bt, bt)
    qv0 = np.ascontiguousarray(planes.transpose(2, 0, 1, 3))
    return qv0, (qv0 <= 0).astype(np.int8)


def test_reference_matches_jax_kernel(monkeypatch):
    """BG2 Z=16, B=256 in two tiles of 128, 10 iterations, Minsumbf16: the
    plain version equals the JAX Pallas kernel run in interpret mode."""
    monkeypatch.setenv("LDPC_RESIDENT_UNROLL", "1")
    jlg, tlg = lifted_graphs("bg2z16")
    x = llrs(tlg.n, 256, 1.3, seed=11)
    qv0, bits0 = _tiles(tlg, x, 128)
    jrule = jax_fused_bp2.rule_for(jax_factory.make_arithmetic("Minsumbf16")[1])
    jbits, jiters, jconv = jax_resident.resident_layered_decode(
        jnp.asarray(qv0), jnp.asarray(bits0),
        jax_fused_bp2.build_fused_layout(jlg), jrule, 10,
    )
    rule = fused_bp2.rule_for(make_arithmetic("Minsumbf16")[1])
    layout = layout_to_device(fused_bp2.build_fused_layout(tlg), "cpu")
    bits, iters, conv = resident_layered_decode_reference(
        as_torch(qv0), as_torch(bits0), layout, rule, 10
    )
    np.testing.assert_array_equal(np.asarray(jbits), bits.numpy())
    np.testing.assert_array_equal(np.asarray(jiters)[:, 0, :], iters.numpy())
    np.testing.assert_array_equal(np.asarray(jconv)[:, 0, :], conv.numpy())
    assert 0 < conv.sum() < conv.numel()


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    _, tlg = lifted_graphs("bg2z16")
    qv0, bits0 = _tiles(tlg, llrs(tlg.n, 8, 1.3, seed=2), 4)
    rule = fused_bp2.rule_for(make_arithmetic("HLNormminsumbf16")[1])
    layout = layout_to_device(fused_bp2.build_fused_layout(tlg), "cpu")
    resident_layered_decode.launches = 0
    args = (as_torch(qv0), as_torch(bits0), layout, rule, 5)
    out = resident_layered_decode(*args)
    ref = resident_layered_decode_reference(*args)
    assert resident_layered_decode.launches == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_build_refuses_without_toolkit(monkeypatch):
    """No CUDA device or no nvcc: the build raises and nothing falls back."""
    with pytest.raises(RuntimeError):
        _build.library_path("resident_layered")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "_TOOLKIT_NVCC", _build.BUILD_DIR / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("resident_layered")

