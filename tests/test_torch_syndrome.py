"""The streaming loop's test and freeze (``fused_syndrome_freeze``'s plain
version under ``decoder/compaction.staged_while_decode``) against the JAX
package's ``staged_while_decode`` with the Pallas ``fused_syndrome_bits``
in interpret mode, at tolerance 0.

Both loops get the same scripted sequence of bit tiles, made with numpy
from a seed: the bits a frame gives at iteration i are one of a few
codewords of the code (every check satisfied) or random bits (checks
unsatisfied). The iteration is a lookup in the script by (iteration,
frame), so compaction's gathers and the freeze are all that is tested.
The JAX loop runs tiles of 128 frames, the port's of 4: the results, in
frame order, must not depend on the tiling. The CUDA kernel is held
against the plain version in test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu.decoder.compaction import staged_while_decode as jax_staged
from ldpc_toolbox_tpu.ops import fused_bp2 as jax_fused_bp2
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.convert import layout_to_device
from ldpc_toolbox_torch.decoder.compaction import staged_while_decode
from ldpc_toolbox_torch.encoder import Encoder
from ldpc_toolbox_torch.ops import fused_bp2

from torch_parity import lifted_graphs, parity_check

#: frames, the iteration budget, the JAX loop's tile width, the port's
B, ITERS, JAX_BT, BT = 256, 8, 128, fused_bp2.BT
#: distinct codewords a script draws from
CODEWORDS = 8


@functools.cache
def _code(code):
    """(JAX FusedLayout, port layout on the CPU, the port graph's column
    of each (variable group, lane), CODEWORDS codewords (CODEWORDS, n)) of
    a test code."""
    jlg, tlg = lifted_graphs(code)
    enc = Encoder(parity_check(code, torch_codes), device="cpu")
    msgs = np.random.default_rng(9).integers(0, 2, (CODEWORDS, enc.k), dtype=np.uint8)
    words = enc.encode_batch(torch.from_numpy(msgs)).numpy()
    return (
        jax_fused_bp2.build_fused_layout(jlg),
        layout_to_device(fused_bp2.build_fused_layout(tlg), "cpu"),
        tlg.var_cols[tlg.var_group_order],
        words,
    )


def _script(code, scenario):
    """(script (ITERS + 1, B, VG, Z) int8, each frame's first passing
    iteration, ITERS + 1 for none): "mixed" frames pass first at iterations
    0 to ITERS or never, and after their first pass give random bits or
    another codeword; "none" never pass; "at0" pass at iteration 0 and
    give random bits after."""
    _, _, col_of, words = _code(code)
    rng = np.random.default_rng({"mixed": 1, "none": 2, "at0": 3}[scenario])
    VG, Z = col_of.shape
    script = rng.integers(0, 2, (ITERS + 1, B, VG, Z), dtype=np.int8)
    if scenario == "mixed":
        first = rng.integers(0, ITERS + 3, B)
    else:
        first = np.full(B, 0 if scenario == "at0" else ITERS + 1)
    planes = words[:, col_of].astype(np.int8)  # (CODEWORDS, VG, Z)
    for f in range(B):
        if first[f] > ITERS:
            continue
        script[first[f], f] = planes[rng.integers(CODEWORDS)]
        if scenario == "mixed":
            for i in range(first[f] + 1, ITERS + 1):
                if rng.random() < 0.5:
                    script[i, f] = planes[rng.integers(CODEWORDS)]
    return script, np.minimum(first, ITERS + 1)


@functools.cache
def _jax_loop(code):
    """JAX ``staged_while_decode`` over a script, jitted once a code."""
    jl = _code(code)[0]
    nbt = B // JAX_BT

    def ok(bits):
        return jax_fused_bp2.fused_syndrome_bits(bits, jl)[:, 0, :].reshape(-1) == 0

    def run(script):
        def bits_at(it, ids):  # (t, 1, 1, bt) each -> (t, VG, Z, bt)
            return script[it[:, 0, 0, :], ids[:, 0, 0, :]].transpose(0, 2, 3, 1)

        def iteration(big, const):
            it = big[0] + 1
            return (it,), bits_at(it, const[0])

        ids = jnp.arange(B, dtype=jnp.int32).reshape(nbt, 1, 1, JAX_BT)
        it0 = jnp.zeros_like(ids)
        bits0 = bits_at(it0, ids)
        return jax_staged(
            nbt=nbt, bt=JAX_BT, max_iterations=ITERS, init_big=(it0,), const_big=(ids,),
            bits0=bits0, ok0=ok(bits0), iteration=iteration, syndrome_ok=ok,
        )

    return jax.jit(run)


def _torch_loop(code, script):
    """The port's ``staged_while_decode`` over a script with the plain
    freeze; (bits (VG, Z, B), iters (B,), conv (B,) bool) as JAX's."""
    tl = _code(code)[1]
    s = torch.from_numpy(script)
    nbt = B // BT

    def bits_at(it, ids):
        return s[it[:, 0, 0, :], ids[:, 0, 0, :]].permute(0, 2, 3, 1).contiguous()

    def iteration(state, const):
        it = state[0] + 1
        return (it,), bits_at(it, const[0])

    ids = torch.arange(B).reshape(nbt, 1, 1, BT)
    it0 = torch.zeros_like(ids)
    bits, iters, conv = staged_while_decode(
        max_iterations=ITERS, state=(it0,), const=(ids,), bits0=bits_at(it0, ids),
        iteration=iteration,
        freeze=functools.partial(fused_bp2.fused_syndrome_freeze_reference, layout=tl),
    )
    VG, Z = bits.shape[1:3]
    return (bits.permute(1, 2, 0, 3).reshape(VG, Z, B).numpy(), iters.reshape(-1).numpy(),
            conv.reshape(-1).numpy() != 0)


@pytest.mark.parametrize("scenario", ["mixed", "none", "at0"])
@pytest.mark.parametrize("code", ["bg2z16", "R1_4short"])
def test_staged_freeze_matches_jax(code, scenario):
    script, first = _script(code, scenario)
    jbits, jiters, jconv = (np.asarray(x) for x in _jax_loop(code)(jnp.asarray(script)))
    bits, iters, conv = _torch_loop(code, script)
    np.testing.assert_array_equal(jconv, conv)
    np.testing.assert_array_equal(jiters, iters)
    np.testing.assert_array_equal(jbits, bits)
    # and what the script says: a frame's count and bits freeze at its
    # first pass; one that never passes ends with ITERS and its last bits
    passed = first <= ITERS
    np.testing.assert_array_equal(conv, passed)
    np.testing.assert_array_equal(iters, np.where(passed, first, ITERS))
    frames = np.arange(B)
    expect = script[np.where(passed, first, ITERS), frames].transpose(1, 2, 0)
    np.testing.assert_array_equal(bits, expect)
    if scenario == "mixed":
        assert 0 < passed.sum() < B and len(set(first[passed])) == ITERS + 1
