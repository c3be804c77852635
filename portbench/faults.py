"""Faults planted in the program under test, to show that the check
catches them (``tests/test_portbench_faults.py``, ``control.py
--fault``). Each wraps the ``BerTest``'s decode:

* ``unchanged``: the decode returns the channel's hard decisions as they
  came in, no iteration run;
* ``half_batch``: only the first half of the batch is decoded, the second
  half answered with the first half's answers;
* ``altered_answer``: one bit of one frame's decoded codeword is flipped
  where it is produced.
"""

from __future__ import annotations

import torch

__all__ = ["FAULTS", "plant"]


def _unchanged(decode):
    def faulty(graph, arithmetic, llr, max_iterations):
        B = llr.shape[0]
        return {
            "codeword": (llr <= 0).to(torch.uint8),
            "iterations": torch.zeros(B, dtype=torch.int32, device=llr.device),
            "success": torch.zeros(B, dtype=torch.bool, device=llr.device),
        }
    return faulty


def _half_batch(decode):
    def faulty(graph, arithmetic, llr, max_iterations):
        half = llr.shape[0] // 2
        out = decode(graph, arithmetic, llr[:half], max_iterations)
        return {k: torch.cat([v, v[: llr.shape[0] - half]]) for k, v in out.items()}
    return faulty


def _altered_answer(decode):
    def faulty(graph, arithmetic, llr, max_iterations):
        out = decode(graph, arithmetic, llr, max_iterations)
        out["codeword"][0, 0] ^= 1
        return out
    return faulty


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered_answer": _altered_answer}


def plant(test, name):
    """Replaces ``test``'s decode by its faulty form."""
    test.decode = FAULTS[name](test.decode)
