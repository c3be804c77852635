"""Shared helpers of the tests that hold ldpc_toolbox_torch against the JAX
package: identical inputs made with numpy from a seed, and exact
comparison of decoder outputs."""

import numpy as np
import torch

from ldpc_toolbox_tpu.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
from ldpc_toolbox_tpu.decoder import lifted as jax_lifted
from ldpc_toolbox_torch.decoder import lifted as torch_lifted

# The parity tests run many small ops on small planes; one intra-op thread
# per process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

#: the test codes by name: DVB-S2 normal and short frames, 5G BG2 at
#: Z=16, and CCSDS C2 (Z=511)
CODES = ("R1_2", "R1_4short", "bg2z16", "ccsds-c2")


def lifted_graphs(name):
    """(JAX LiftedGraph, port LiftedGraph) of a test code."""
    if name == "bg2z16":
        bg, z = BaseGraph.BG2, 16
        h = bg.h(z)
        return (
            jax_lifted.LiftedGraph.from_sparse(h, *jax_lifted.nr5g_maps(bg, z)),
            torch_lifted.LiftedGraph.from_sparse(h, *torch_lifted.nr5g_maps(bg, z)),
        )
    if name == "ccsds-c2":
        from ldpc_toolbox_tpu.codes.ccsds import C2Code

        code = C2Code()
    else:
        code = DvbCode[name]
    return jax_lifted.lifted_graph_for(code), torch_lifted.lifted_graph_for(code)


def llrs(n, batch, sigma, seed):
    """BPSK all-zero-codeword channel LLRs, float32 (batch, n)."""
    rng = np.random.default_rng(seed)
    x = -1.0 + sigma * rng.standard_normal((batch, n))
    return ((-2.0 / sigma**2) * x).astype(np.float32)


def assert_same_decode(jax_out, torch_out):
    """Bit-for-bit equal success, iterations and codewords, with a mix of
    converged and failed frames."""
    s = np.asarray(jax_out["success"])
    np.testing.assert_array_equal(s, torch_out["success"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_out["iterations"]), torch_out["iterations"].numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jax_out["codeword"]), torch_out["codeword"].numpy()
    )
    assert 0 < s.sum() < s.size, f"no convergence mix: {s.sum()}/{s.size}"


def as_torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))
