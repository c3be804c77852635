"""The streaming layered sweep of the float names against the JAX
package: the port's plain ``fused_layered_iteration_reference`` against
JAX's Pallas ``fused_layered_iteration`` in interpret mode, one and two
sweeps on the same planes of 5G BG2 z=16 (one JAX tile of 128 frames: the
channel posteriors of 96 noisy and 32 large-magnitude frames in the
rule's type, and a zero Rcv), for the four rules, two in f32 and two in
f64 (the check phases of test_torch_streaming_float.py hold all eight
rule and precision pairs; a sweep in interpret mode takes about 25 s);
within
the tolerances of tests/test_torch_float.py, with torch's transcendentals
on both sides (see test_torch_streaming_float.py). The CUDA instances are
held against the plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_tpu.ops.fused_layered import (
    fused_layered_iteration as jax_fused_layered_iteration,
)
from ldpc_toolbox_torch.decoder import lifted_layered
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.ops.fused_layered import fused_layered_iteration_reference

from test_torch_streaming_float import JAX_BT, _close, _layouts, _rules
from torch_parity import lifted_graphs, llrs, strong_llrs, torch_transcendentals


@pytest.mark.parametrize("decoder", ["HLPhif32", "HLTanhf64", "HLMinstarapproxf32",
                                     "HLAminstarf64"])
def test_sweep_matches_jax(decoder, monkeypatch):
    torch_transcendentals(monkeypatch, jax_fused_bp2)
    jl, tl = _layouts()
    jrule, rule = _rules(decoder)
    _, tlg = lifted_graphs("bg2z16")
    x = np.concatenate([llrs(tlg.n, 96, 1.3, seed=5), strong_llrs(tlg.n, 32, seed=6)])
    qv0, _, _, _ = lifted_layered.tile_inputs(tlg, make_arithmetic(decoder)[1],
                                              torch.from_numpy(x))
    qv = qv0.permute(1, 2, 0, 3).reshape(1, tl.VG, tl.Z, JAX_BT).contiguous()
    assert qv.dtype == rule.storage_dtype
    rcv = torch.zeros((1, tl.E, tl.Z, JAX_BT), dtype=rule.storage_dtype)
    # copies: a JAX array made from a numpy array may share its memory,
    # and the plain version updates qv and rcv in place
    jqv, jrcv = jnp.asarray(qv.numpy().copy()), jnp.asarray(rcv.numpy().copy())
    for _ in range(2):
        out = fused_layered_iteration_reference(qv, rcv, tl, rule)
        jqv, jrcv, jbits = jax_fused_layered_iteration(jqv, jrcv, jl, jrule)
        _close(jqv, out[0])
        _close(jrcv, out[1])
        np.testing.assert_array_equal(np.asarray(jbits), out[2].numpy())
    assert 0 < int(out[2].sum()) < out[2].numel()
