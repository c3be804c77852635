"""The port's BER harness beyond the step: checkpoints and resume (the
JAX package's tests/test_ber_aux.py cases, and its JSON keys), a point
interrupted by Ctrl-C and resumed to exactly the counters of an
uninterrupted run, the reporter's calls, and a whole-pipeline FER (8PSK,
puncturing and interleaving on a 66-column code) against the JAX
package's ``BerTest`` within a two-proportion test."""

import functools
import json
import math

import pytest
import torch

from ldpc_toolbox_tpu.mackay_neal import Config as JaxMNConfig
from ldpc_toolbox_tpu.simulation import BerTestBuilder as JaxBerTestBuilder
from ldpc_toolbox_tpu.simulation import Modulation as JaxModulation
from ldpc_toolbox_tpu.systematic import parity_to_systematic as jax_parity_to_systematic
from ldpc_toolbox_torch.mackay_neal import Config as MNConfig
from ldpc_toolbox_torch.simulation import BerTestBuilder, Modulation
from ldpc_toolbox_torch.systematic import parity_to_systematic

# The tests run many small ops on small tensors; one intra-op thread per
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


@functools.cache
def small_codes():
    """(JAX h, port h) of the JAX package's checkpoint tests' code."""
    conf = dict(nrows=32, ncols=64, wr=6, wc=3)
    return (jax_parity_to_systematic(JaxMNConfig(**conf).run(11)),
            parity_to_systematic(MNConfig(**conf).run(11)))


def _builder(**kw):
    defaults = dict(
        h=small_codes()[1],
        decoder_implementation="Minsumf32",
        ebn0s_db=[3.0, 4.0],
        max_frame_errors=6,
        max_iterations=20,
        batch_size=64,
        seed=5,
        device="cpu",
    )
    defaults.update(kw)
    return BerTestBuilder(**defaults)


def _counts(stats):
    return [(s.num_frames, s.ldpc.bit_errors, s.ldpc.frame_errors, s.false_decodes,
             s.total_iterations, s.ldpc.correct_iterations) for s in stats]


def test_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "sweep.json")
    full = _builder(checkpoint_path=ckpt).build().run()
    # run again: every point comes back from the checkpoint, no new work
    calls = []
    test = _builder(checkpoint_path=ckpt).build()
    test.step = lambda *a: calls.append(a)
    resumed = test.run()
    assert len(resumed) == len(full) == 2 and not calls
    assert _counts(resumed) == _counts(full)


def test_checkpoint_partial_resume(tmp_path):
    ckpt = str(tmp_path / "sweep.json")
    # complete only the first point, then stop before the second
    s1 = _builder(ebn0s_db=[3.0], checkpoint_path=ckpt).build().run()
    with open(ckpt) as f:
        state = json.load(f)
    state["ebn0s_db"] = [3.0, 4.0]
    with open(ckpt, "w") as f:
        json.dump(state, f)
    s2 = _builder(checkpoint_path=ckpt).build().run()
    assert len(s2) == 2
    # the first point restored as it was, the second run afresh
    assert _counts(s2[:1]) == _counts(s1)
    assert _counts(s2[1:]) == _counts(_builder(ebn0s_db=[3.0, 4.0]).build().run()[1:])


@pytest.mark.parametrize("change", [{"seed": 6}, {"ebn0s_db": [3.0, 4.5]},
                                    {"decoder_implementation": "HLMinsumf32"}])
def test_checkpoint_invalidated_by_params(tmp_path, change):
    ckpt = str(tmp_path / "sweep.json")
    _builder(checkpoint_path=ckpt).build().run()
    # other parameters: the checkpoint is ignored, the sweep runs afresh
    out = _builder(checkpoint_path=ckpt, **change).build().run()
    assert len(out) == 2 and out[0].num_frames > 0
    assert _counts(out) == _counts(_builder(**change).build().run())


def test_checkpoint_keys_match_jax(tmp_path):
    """The same sweep in both packages leaves a checkpoint with the same
    JSON keys, at every level, and the same parameters."""
    jh, th = small_codes()
    common = dict(decoder_implementation="Minsumf32", ebn0s_db=[3.0], max_frame_errors=2,
                  max_iterations=10, batch_size=32, seed=1, bch_max_errors=1)
    states = []
    for builder, h, extra in ((JaxBerTestBuilder, jh, {}),
                              (BerTestBuilder, th, {"device": "cpu"})):
        path = tmp_path / f"{builder.__module__}.json"
        builder(h=h, checkpoint_path=str(path), **common, **extra).build().run()
        states.append(json.loads(path.read_text()))
    jstate, state = states
    assert state.keys() == jstate.keys()
    assert state["counters"].keys() == jstate["counters"].keys()
    (done,), (jdone,) = state["completed"], jstate["completed"]
    assert done.keys() == jdone.keys()
    assert done["ldpc"].keys() == jdone["ldpc"].keys()
    assert done["bch"].keys() == jdone["bch"].keys()
    for key in ("version", "seed", "ebn0s_db", "decoder", "point", "step_idx",
                "point_elapsed", "counters"):
        assert state[key] == jstate[key], key


class _Interrupt:
    """A reporter that raises KeyboardInterrupt at its ``at``-th
    intermediate call, as Ctrl-C would, and records every call."""

    def __init__(self, at=None):
        self.at = at
        self.calls = []

    def __call__(self, stats, final):
        self.calls.append((stats.ebn0_db, stats.num_frames, final))
        if not final and sum(not f for *_, f in self.calls) == self.at:
            raise KeyboardInterrupt


def test_interrupted_point_resumes_exactly(tmp_path):
    """Ctrl-C in the middle of the second point saves its partial state;
    the resumed sweep's counters equal an uninterrupted sweep's exactly
    (each step's noise depends on (seed, point, step) alone; the stop rule
    is the frame errors alone)."""
    kw = dict(max_frame_errors=40, report_interval=0.0)
    ckpt = str(tmp_path / "sweep.json")
    full = _builder(**kw).build().run()
    steps_first = full[0].num_frames // 64
    reporter = _Interrupt(at=steps_first + 2)
    with pytest.raises(KeyboardInterrupt):
        _builder(checkpoint_path=ckpt, reporter=reporter, **kw).build().run()
    with open(ckpt) as f:
        state = json.load(f)
    assert state["point"] == 1 and state["step_idx"] == 2
    assert state["counters"]["num_frames"] == 128
    assert len(state["completed"]) == 1
    resumed = _builder(checkpoint_path=ckpt, **kw).build().run()
    assert _counts(resumed) == _counts(full)
    assert resumed[1].ldpc.frame_errors >= 40


def test_reporter_calls():
    """Every step (report_interval 0) reports its point's running
    statistics with final=False; each point ends with one final=True."""
    reporter = _Interrupt()
    stats = _builder(reporter=reporter, report_interval=0.0).build().run()
    finals = [c for c in reporter.calls if c[2]]
    assert finals == [(s.ebn0_db, s.num_frames, True) for s in stats]
    for s in stats:
        running = [n for e, n, f in reporter.calls if e == s.ebn0_db and not f]
        assert running == list(range(64, s.num_frames + 1, 64))
    # the default interval reports less often than every step
    reporter = _Interrupt()
    _builder(reporter=reporter).build().run()
    assert [c for c in reporter.calls if c[2]] == finals


def test_pipeline_fer_matches_jax():
    """8PSK with the last of 11 blocks punctured and a 3-column
    interleaver on the 66-column MacKay-Neal code of the JAX package's
    8PSK test, ``Minsumf32``: the FER of the port's sweep and of the JAX
    package's agree (two-proportion |z| <= 3.29)."""
    conf = dict(nrows=30, ncols=66, wr=8, wc=3)
    jh = jax_parity_to_systematic(JaxMNConfig(**conf).run(5))
    th = parity_to_systematic(MNConfig(**conf).run(5))
    common = dict(decoder_implementation="Minsumf32", ebn0s_db=[4.0],
                  puncturing_pattern=[True] * 10 + [False], interleaving_columns=3,
                  max_frame_errors=300, max_iterations=20, batch_size=512, seed=3)
    (js,) = JaxBerTestBuilder(h=jh, modulation=JaxModulation.PSK8, **common).build().run()
    (s,) = BerTestBuilder(h=th, modulation=Modulation.PSK8, device="cpu", **common).build().run()
    (n1, e1), (n2, e2) = (js.num_frames, js.ldpc.frame_errors), (s.num_frames, s.ldpc.frame_errors)
    assert e1 >= 300 and e2 >= 300 and e2 < n2
    p = (e1 + e2) / (n1 + n2)
    z = (e1 / n1 - e2 / n2) / math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    assert abs(z) <= 3.29, ((e1, n1), (e2, n2))
