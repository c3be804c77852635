"""The nine counters of a ``ber`` step (ber.rs:436-481), from the
messages and the decoder's answer: bit errors counted on the k systematic
bits; a frame in error if any differs; a false decode is a frame in error
that the decoder called a success; the iterations of all frames and of
those without error; and the same with the virtual BCH decoder, which at
``ber``'s default (no ``--bch-max-errors``) corrects nothing, so that its
three counters repeat the decoder's."""

from __future__ import annotations

import torch

__all__ = ["NAMES", "step_counters"]

NAMES = (
    "num_frames", "bit_errors", "frame_errors", "false_decodes",
    "total_iterations", "correct_iterations", "bch_bit_errors",
    "bch_frame_errors", "bch_correct_iterations",
)


def step_counters(msg, codeword, iterations, success) -> dict:
    k = msg.shape[1]
    errors = (codeword[:, :k] != msg).sum(dim=1).to(torch.int64)
    bad = errors > 0
    its = iterations.to(torch.int64)
    values = (
        msg.shape[0],
        errors.sum(),
        bad.sum(),
        (bad & success).sum(),
        its.sum(),
        its[~bad].sum(),
        errors.sum(),
        bad.sum(),
        its[~bad].sum(),
    )
    return dict(zip(NAMES, (int(v) for v in values)))
