"""The port's spans and counters (``ldpc_toolbox_torch/telemetry.py``) on
the CPU: with no profiler recording and no ``counting()`` block they do
nothing; under ``torch.profiler`` a ``BerTest.step`` exports every span
of the step, nested as the step runs; ``tile_iterations`` counts the
iterations each tile of a resident or compressed decode ran."""

import json
from collections import Counter

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from ldpc_toolbox_torch import telemetry
from ldpc_toolbox_torch.codes.dvbs2 import Code
from ldpc_toolbox_torch.decoder import lifted_decode_for
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted import lifted_graph_for
from ldpc_toolbox_torch.decoder.lifted_layered import plain_layered_decode
from ldpc_toolbox_torch.ops.fused_bp2 import BT
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.simulation.ber import step_generator

CODE = Code.R1_4short
#: an Eb/N0 where some frames of a step converge early and some do not
SIGMA = 0.8
#: each span's parent, None at the top (the step's generator is drawn
#: before the step)
PARENT = {
    "generator": None, "step": None,
    "draw": "step", "encode": "step", "channel": "step", "decode": "step",
    "counters": "step", "counters.read": "counters",
    "decode.tiles_in": "decode", "decode.kernel": "decode", "decode.tiles_out": "decode",
}
STEP_ORDER = ["draw", "encode", "channel", "decode", "counters"]


@pytest.fixture(scope="module")
def graph():
    return lifted_graph_for(CODE)


def _test(graph, decoder, batch=8, lifted=True):
    return BerTestBuilder(
        h=CODE.h(), lifted_graph=graph if lifted else None,
        decoder_implementation=decoder, max_iterations=8, batch_size=batch,
        device="cpu",
    ).build()


def _spans(prof, tmp_path):
    """The exported trace's ``ldpc.*`` rows as (start, end, name)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"][len(telemetry.PREFIX):])
                  for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(telemetry.PREFIX))


def _parent(span, spans):
    """The name of the innermost span that holds ``span``, None if none."""
    start, end, _ = span
    around = [s for s in spans if s is not span and s[0] <= start and end <= s[1]]
    return max(around, key=lambda s: s[0])[2] if around else None


def _tile_count(iterations):
    """The iterations each BT-frame tile ran, from the frames' own counts:
    pad frames converge at iteration 0."""
    pad = -iterations.shape[0] % BT
    return int(F.pad(iterations, (0, pad)).reshape(-1, BT).amax(dim=1).sum())


class _Ops(TorchDispatchMode):
    """Records every aten operation run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_span_without_a_profiler_enters_no_record_function(graph, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert telemetry.span("step") is telemetry.span("decode.kernel")
    for decoder in ("HLMinsumbf16", "Minsumbf16"):
        counters = _test(graph, decoder).step(step_generator(5, 0, 0, "cpu"), SIGMA)
        assert counters["num_frames"] == 8


def test_add_outside_counting_calls_nothing():
    def count():
        raise AssertionError("count called outside counting()")

    with _Ops() as seen:
        telemetry.add("tile_iterations", count)
    assert seen.ops == []


def test_step_outside_counting_runs_no_counter_op(graph):
    """A step runs the same operations with counting off as with it on,
    less the tile count's two (the per-tile maximum and its sum)."""
    test = _test(graph, "HLMinsumbf16")
    with _Ops() as off:
        test.step(step_generator(5, 0, 1, "cpu"), SIGMA)
    with telemetry.counting(), _Ops() as on:
        test.step(step_generator(5, 0, 1, "cpu"), SIGMA)
    assert Counter(on.ops) - Counter(off.ops) == Counter({"aten.amax": 1, "aten.sum": 1})
    assert not Counter(off.ops) - Counter(on.ops)


def test_counting_sums_each_name_and_reads_at_the_end():
    with telemetry.counting() as outer:
        telemetry.add("a", lambda: torch.tensor(3))
        with telemetry.counting() as inner:
            telemetry.add("a", lambda: torch.tensor(10))
        telemetry.add("a", lambda: torch.tensor(4))
        telemetry.add("b", lambda: torch.tensor(1))
        assert outer == {}  # read when the block ends
    assert outer == {"a": 7, "b": 1}
    assert inner == {"a": 10}
    with pytest.raises(RuntimeError):
        with telemetry.counting() as failed:
            telemetry.add("a", lambda: torch.tensor(1))
            raise RuntimeError("the block fails")
    assert failed == {}
    telemetry.add("a", lambda: pytest.fail("a counting() block is still open"))


@pytest.mark.parametrize("decoder", ["HLMinsumbf16", "Minsumbf16"], ids=["layered", "flooding"])
def test_profiled_step_exports_every_span_nested(graph, decoder, tmp_path):
    test = _test(graph, decoder)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            test.step(step_generator(5, 0, i, "cpu"), SIGMA)
    spans = _spans(prof, tmp_path)
    assert Counter(s[2] for s in spans) == Counter({name: 2 for name in PARENT})
    for s in spans:
        assert _parent(s, spans) == PARENT[s[2]], s
    steps = [s for s in spans if s[2] == "step"]
    for step in steps:
        inside = [s[2] for s in spans if s[2] in STEP_ORDER and step[0] <= s[0] <= step[1]]
        assert inside == STEP_ORDER


def test_generic_decode_has_the_step_spans_only(graph, tmp_path):
    """The generic parity-check decode has no kernel tiles: its step has
    ``ldpc.decode`` and no span inside it."""
    test = _test(graph, "Minsumbf16", lifted=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        test.step(step_generator(5, 0, 0, "cpu"), SIGMA)
    names = Counter(s[2] for s in _spans(prof, tmp_path))
    assert names == Counter(n for n in PARENT if not n.startswith("decode."))


@pytest.mark.parametrize("decoder, batch", [
    ("HLMinsumbf16", 8), ("HLMinsumf32", 8), ("Minsumbf16", 8), ("Minsumf32", 8),
    ("HLMinsumbf16", 6), ("Minsumbf16", 6),
], ids=["layered", "layered-compressed", "flooding", "flooding-compressed",
        "layered-partial-tile", "flooding-partial-tile"])
def test_tile_iterations_equal_the_count_from_the_frames(graph, decoder, batch):
    schedule, arithmetic = make_arithmetic(decoder)
    noise = torch.randn((batch, CODE.n), generator=torch.Generator().manual_seed(3))
    llrs = (2.0 / SIGMA**2) * (1.0 + SIGMA * noise)  # the all-zero codeword, BPSK
    with telemetry.counting() as counts:
        out = lifted_decode_for(schedule)(graph, arithmetic, llrs, 8)
    iterations = out["iterations"]
    assert 0 < int(iterations.min()) < int(iterations.max())  # tiles stop apart
    assert counts == {"tile_iterations": _tile_count(iterations)}


def test_tile_iterations_of_steps_equal_the_count_from_their_decodes(graph):
    test = _test(graph, "Minsumbf16", batch=16)
    decode, outs = test.decode, []

    def kept(*args):
        outs.append(decode(*args))
        return outs[-1]

    test.decode = kept
    with telemetry.counting() as counts:
        total = sum(test.step(step_generator(5, 0, i, "cpu"), SIGMA)["total_iterations"]
                    for i in range(3))
    tiles = counts["tile_iterations"]
    assert tiles == sum(_tile_count(out["iterations"]) for out in outs)
    assert total < BT * tiles  # some tile held a frame that had stopped


@pytest.mark.parametrize("decoder", ["HLMinsumbf16", "Minsumbf16"], ids=["layered", "flooding"])
def test_streaming_and_plain_forms_count_no_tiles(graph, decoder):
    schedule, arithmetic = make_arithmetic(decoder)
    llrs = torch.full((4, CODE.n), 3.0)
    with telemetry.counting() as counts:
        lifted_decode_for(schedule)(graph, arithmetic, llrs, 4, resident=False)
        if schedule == "layered":
            plain_layered_decode(graph, arithmetic, llrs, 4)
    assert counts == {}
