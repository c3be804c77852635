"""The streaming layered form against the JAX package: the plain version of
``fused_layered_iteration`` against JAX's Pallas ``fused_layered_iteration``
(interpret mode) on the same planes for one and two sweeps, and the whole
``lifted_layered_decode(..., resident=False)`` (the sweep and the syndrome
under staged compaction) against JAX's ``fused=True, resident=False,
compact=True``, bit for bit. The CUDA kernel is held against the plain
version in test_torch_cuda.py.

Case: 5G BG2 Z=16, B=256 (two JAX tiles of 128, 64 port tiles of 4),
sigma=1.3; the whole decode at 6 iterations, where frames converge at
three or more different iterations, so the later compaction stages run
(tests/test_lifted_layered.py:171-198)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder import factory as jax_factory
from ldpc_toolbox_tpu.decoder.lifted_layered import (
    lifted_layered_decode as jax_layered,
)
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_tpu.ops.fused_layered import (
    fused_layered_iteration as jax_fused_layered_iteration,
)
from ldpc_toolbox_torch.decoder import lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops.fused_layered import fused_layered_iteration_reference

from torch_parity import as_torch, assert_same_decode, lifted_graphs, llrs

BATCH, SIGMA = 256, 1.3
#: the JAX kernels' tile width
JAX_BT = 128
DECODERS = ["HLMinsumf32", "HLMinsumbf16"]


@functools.cache
def _inputs():
    jlg, tlg = lifted_graphs("bg2z16")
    return jlg, tlg, llrs(tlg.n, BATCH, SIGMA, seed=11)


def _tiles(planes, bt):
    """(P, Z, B) numpy planes -> (B // bt, P, Z, bt) tiles."""
    P, Z, B = planes.shape
    return np.ascontiguousarray(planes.reshape(P, Z, B // bt, bt).transpose(2, 0, 1, 3))


def _planes(tiles):
    """(nbt, P, Z, bt) tiles -> (P, Z, nbt * bt) numpy planes."""
    t = np.asarray(tiles)
    return t.transpose(1, 2, 0, 3).reshape(t.shape[1], t.shape[2], -1)


@functools.cache
def _qv0():
    """The case's f32 posteriors init as (VG, Z, B) planes."""
    _, tlg, x = _inputs()
    col = tlg.var_cols[tlg.var_group_order].reshape(-1)
    return np.ascontiguousarray(x.T[col].reshape(tlg.num_var_groups, tlg.Z, BATCH))


@functools.cache
def _jax_sweeps(decoder):
    """JAX (qv, rcv, bits) after one and after two sweeps from qv0 and a
    zero rcv, as (P, Z, B) planes."""
    jlg, _, _ = _inputs()
    jl = jax_fused_bp2.build_fused_layout(jlg)
    rule = jax_fused_bp2.rule_for(jax_factory.make_arithmetic(decoder)[1])
    qv = jnp.asarray(_tiles(_qv0(), JAX_BT))
    rcv = jnp.zeros((BATCH // JAX_BT, jl.E, jl.Zp, JAX_BT), rule.storage_dtype)
    out = []
    for _ in range(2):
        qv, rcv, bits = jax_fused_layered_iteration(qv, rcv, jl, rule)
        out.append(tuple(_planes(a.astype(jnp.float32)) for a in (qv, rcv, bits)))
    return out


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("decoder", DECODERS)
def test_sweep_matches_jax(decoder, sweeps):
    _, tlg, _ = _inputs()
    layout = lifted_layered.device_layout(tlg, "cpu")
    rule = lifted_layered.rule_for(make_arithmetic(decoder)[1])
    qv = as_torch(_tiles(_qv0(), 4))
    rcv = torch.zeros((BATCH // 4, layout.E, layout.Z, 4), dtype=rule.storage_dtype)
    for _ in range(sweeps):
        out = fused_layered_iteration_reference(qv, rcv, layout, rule)
        assert out[0] is qv and out[1] is rcv  # in place
    for jax_plane, port in zip(_jax_sweeps(decoder)[sweeps - 1], out):
        np.testing.assert_array_equal(jax_plane, _planes(port.float().numpy()))
    bits = out[2]
    assert bits.dtype == torch.int8 and 0 < int(bits.sum()) < bits.numel()


@functools.cache
def _jax_streaming(decoder):
    jlg, _, x = _inputs()
    _, ja = jax_factory.make_arithmetic(decoder)
    return jax_layered(jlg, ja, jnp.asarray(x), 6, fused=True, resident=False,
                       compact=True)


@pytest.mark.parametrize("decoder", DECODERS)
def test_streaming_decode_matches_jax(decoder):
    _, tlg, x = _inputs()
    jout = _jax_streaming(decoder)
    tout = lifted_layered.lifted_layered_decode(
        tlg, make_arithmetic(decoder)[1], torch.from_numpy(x), 6, resident=False
    )
    assert_same_decode(jout, tout)
    s = tout["success"].numpy()
    assert len(np.unique(tout["iterations"].numpy()[s])) >= 3
