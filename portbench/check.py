"""The comparison that decides ``correct``.

The window keeps a sample of its steps, drawn from the seed: what the
program's step produced at each stage (messages, codewords, LLRs, the
decoder's answer, the nine counters). Once the window has closed the
reference works each stage out again and the numbers below count how far
the program lies from it; a run is correct when every number is within
its limit (the configuration's ``limits``):

* ``msg_bits_differ``, ``cw_bits_differ``: message and codeword bits
  unlike the reference's draw and staircase encode (exact);
* ``llr_rel_err``: the largest |LLR - reference LLR| / (1 + |reference
  LLR|) of the channel (modulation, AWGN, demap, interleaving);
* ``hard_bits_differ``, ``iters_differ``, ``success_differ``: hard
  decisions, per-frame iteration counts and success flags unlike the
  reference decoder's on the program's LLRs (exact: the decoder's
  arithmetic is fixed bit for bit);
* ``counters_differ``: the step's nine counters unlike those the reference
  counts from its messages and its decode (exact);
* ``frames_short``: frames the window's steps did not count, over every
  step (exact).

The decode is judged on the program's LLRs, so that a channel within its
limit does not move the decoder's answer; ``llr_rel_err`` checks that
stage by itself.
"""

from __future__ import annotations

import torch

__all__ = ["NUMBERS", "STEPS", "judge", "correct"]

#: the steps a run keeps for the check (drawn from the seed over the window)
STEPS = 2

NUMBERS = (
    "msg_bits_differ", "cw_bits_differ", "llr_rel_err", "hard_bits_differ",
    "iters_differ", "success_differ", "counters_differ", "frames_short",
)


def judge(kept, reference, generator_of, ebn0_db, frames_short=0) -> dict:
    """The numbers over the kept steps: ``kept`` a list of {"step", "msg",
    "cw", "llr", "out", "counters"}, ``generator_of(step)`` the step's
    generator, ``reference`` a ``reference.step.ReferenceStep``."""
    n = dict.fromkeys(NUMBERS, 0)
    n["llr_rel_err"] = 0.0
    n["frames_short"] = int(frames_short)
    for k in kept:
        msg, cw, llr = reference.inputs(generator_of(k["step"]), ebn0_db)
        n["msg_bits_differ"] += int((k["msg"] != msg).sum())
        n["cw_bits_differ"] += int((k["cw"] != cw).sum())
        err = (k["llr"].double() - llr.double()).abs() / (1.0 + llr.double().abs())
        n["llr_rel_err"] = max(n["llr_rel_err"], float(err.max()))
        out = reference.decode(k["llr"])
        got = k["out"]
        n["hard_bits_differ"] += int((got["codeword"] != out["codeword"]).sum())
        n["iters_differ"] += int((got["iterations"] != out["iterations"]).sum())
        n["success_differ"] += int((got["success"] != out["success"]).sum())
        ref_counts = reference.counters(msg, out)
        n["counters_differ"] += sum(int(k["counters"][c] != v) for c, v in ref_counts.items())
    return n


def correct(numbers, limits) -> bool:
    return all(numbers[name] <= limits[name] for name in NUMBERS)
