"""The encode side of the generic path against the JAX package's: the
``systematic`` copy (``full_rank_rows``, ``systematic_permutation`` and
the permuted H) on the two codes whose trailing square is singular,
MacKay-Neal ``results/mn_512_1024.alist`` (before ``systematic``) and
CCSDS C2 (1022 rows of rank 1020); BerTest's codewords on those codes
through the permutation (encoded on the permuted full-rank rows, sent in
H's column order: they satisfy H and equal the JAX encoder's on the same
messages); and a BerTest step on the MacKay-Neal alist through the
generic decode, whose nine counters equal those computed from the same
draws through the JAX encoder, channel and generic decode, counting the
bit errors at the message positions ``perm[:k]``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu import sparse as jax_sparse
from ldpc_toolbox_tpu import systematic as jax_systematic
from ldpc_toolbox_tpu.decoder import Decoder as JaxDecoder
from ldpc_toolbox_tpu.encoder import Encoder as JaxEncoder
from ldpc_toolbox_tpu.simulation.modulation import Bpsk as JaxBpsk
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch import sparse as torch_sparse
from ldpc_toolbox_torch import systematic
from ldpc_toolbox_torch.cli import _systematic_perm_if_needed
from ldpc_toolbox_torch.decoder.lifted import lifted_graph_for
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.simulation.ber import step_generator

from torch_parity import generic_h

CODES = ["mn-nonsys", "ccsds-c2"]


@pytest.fixture(scope="module")
def systematic_of():
    """code -> both packages' matrices, full-rank rows and permuted
    full-rank rows, and both permutations, each computed once; dropped
    with the module (C2's echelon forms hold millions of entries)."""
    cache = {}

    def get(code):
        if code not in cache:
            cache[code] = _systematic(code)
        return cache[code]

    yield get
    cache.clear()


def _systematic(code):
    jh = generic_h(code, jax_sparse, jax_codes)
    th = generic_h(code, torch_sparse, torch_codes)
    jf, tf = jax_systematic.full_rank_rows(jh), systematic.full_rank_rows(th)
    perm = systematic.systematic_permutation(tf)
    jperm = jax_systematic.systematic_permutation(jf)
    return (jh, th, jf, tf, perm, jperm,
            jax_systematic.permute_columns(jf, perm), systematic.permute_columns(tf, perm))


@pytest.mark.parametrize("code", CODES)
def test_systematic_copy_matches_jax(code, systematic_of):
    jh, th, jf, tf, perm, jperm, jp, tp = systematic_of(code)
    assert (tf is th) == (jf is jh) == (code != "ccsds-c2")
    assert tf.num_rows == jf.num_rows == (1020 if code == "ccsds-c2" else 512)
    for r in range(jf.num_rows):
        assert tf.row_list(r) == jf.row_list(r), r
    np.testing.assert_array_equal(perm, jperm)
    assert sorted(perm) == list(range(th.num_cols))
    for r in range(jp.num_rows):
        assert tp.row_list(r) == jp.row_list(r), r
    if code == "mn-nonsys":
        sys_h = systematic.parity_to_systematic(th)
        assert all(sys_h.row_list(r) == tp.row_list(r) for r in range(tp.num_rows))
        # the committed systematic alist is this code with its columns permuted
        done = generic_h("mn", torch_sparse, torch_codes)
        assert all(sorted(done.row_list(r)) == sorted(tp.row_list(r)) for r in range(512))


@pytest.mark.parametrize("code", CODES)
def test_encode_side_permutation_matches_jax(code, systematic_of):
    """BerTest's codewords, with the permutation the CLI finds, against the
    JAX encoder on the permuted full-rank rows, unpermuted as the JAX
    BerTest does."""
    jh, th, jf, tf, perm, _, jp, _ = systematic_of(code)
    cli_perm, enc_h, encoder = _systematic_perm_if_needed(th, "cpu")
    np.testing.assert_array_equal(cli_perm, perm)
    assert encoder is None and (enc_h is None) == (code != "ccsds-c2")
    lifted = lifted_graph_for(torch_codes.ccsds.C2Code()) if code == "ccsds-c2" else None
    test = BerTestBuilder(h=th, lifted_graph=lifted, systematic_permutation=perm,
                          encoder_h=enc_h, device="cpu").build()
    assert test.k == th.num_cols - tf.num_rows == (7156 if code == "ccsds-c2" else 512)
    msg = np.random.default_rng(7).integers(0, 2, (8, test.k)).astype(np.uint8)
    cw = test.encode(torch.from_numpy(msg)).numpy()
    jcw = np.asarray(JaxEncoder(jp)._encode_batch(jnp.asarray(msg)))[:, np.argsort(perm)]
    np.testing.assert_array_equal(cw, jcw)
    np.testing.assert_array_equal(cw[:, perm[: test.k]], msg)
    dense = th.to_dense().astype(np.int64)
    assert not ((dense @ cw.T.astype(np.int64)) % 2).any()


def test_step_counters_match_jax_through_the_permutation(systematic_of):
    """BerTest.step on the non-systematic MacKay-Neal alist (``HLMinsumf32``,
    the generic layered decode) draws the message, then the noise; the same
    draws through the JAX encoder on the permuted matrix, the JAX channel
    and the JAX generic decode give the same nine counters."""
    jh, th, _, _, perm, _, jp, _ = systematic_of("mn-nonsys")
    batch, iters, sigma = 32, 12, 0.8
    test = BerTestBuilder(
        h=th, decoder_implementation="HLMinsumf32", max_iterations=iters,
        batch_size=batch, bch_max_errors=2, systematic_permutation=perm, device="cpu",
    ).build()
    assert test.graph.n == th.num_cols
    counters = test.step(step_generator(0, 0, 0, "cpu"), sigma)

    gen = step_generator(0, 0, 0, "cpu")
    msg = torch.randint(0, 2, (batch, test.k), generator=gen, dtype=torch.uint8).numpy()
    noise = torch.randn((batch, th.num_cols), generator=gen).numpy()
    jmod = JaxBpsk()
    cw = JaxEncoder(jp)._encode_batch(jnp.asarray(msg))[:, np.argsort(perm)]
    llr = jmod.demodulate(jmod.modulate(cw) + sigma * jnp.asarray(noise), sigma)
    out = JaxDecoder(jh, "HLMinsumf32").decode_batch(llr, iters)
    errbits = (np.asarray(out["codeword"])[:, perm[: test.k]] != msg).sum(axis=1)
    frame_err = errbits > 0
    it = np.asarray(out["iterations"])
    bch_err = errbits > 2
    expected = {
        "num_frames": batch,
        "bit_errors": errbits.sum(),
        "frame_errors": frame_err.sum(),
        "false_decodes": (frame_err & np.asarray(out["success"])).sum(),
        "total_iterations": it.sum(),
        "correct_iterations": np.where(frame_err, 0, it).sum(),
        "bch_bit_errors": np.where(bch_err, errbits, 0).sum(),
        "bch_frame_errors": bch_err.sum(),
        "bch_correct_iterations": np.where(bch_err, 0, it).sum(),
    }
    assert counters == {k: int(v) for k, v in expected.items()}
    assert 0 < counters["frame_errors"] < batch
