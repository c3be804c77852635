"""The reduction of a profiler trace by the program's ``ldpc.*`` spans:
device rows, synchronising calls, launches and idle gaps by the innermost
span open on the host, the decode's glue against its kernel, and the idle
split into sync and launch gaps; ``trace.reduce`` unmoved by the
program's rows."""

import random

import pytest

from portbench import program_trace, trace
from test_portbench_imports import JAX, _loaded


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _span(name, ts, dur):
    return _x("user_annotation", "ldpc." + name, ts, dur)


#: two steps in the harness's ranges; times in microseconds
RANGES = [
    _x("user_annotation", "pb.step", 0, 100),
    _x("user_annotation", "pb.encode", 9, 6),
    _x("user_annotation", "pb.decode", 20, 40),
    _x("user_annotation", "pb.counters", 59, 41),  # opened inside ldpc.decode
    _x("user_annotation", "pb.step", 100, 50),
    _x("user_annotation", "pb.decode", 105, 35),
    _x("user_annotation", "pb.counters", 139, 11),
]
SPANS = [
    _span("generator", 1, 2),
    _span("step", 4, 94),
    _span("draw", 5, 3),
    _span("encode", 9, 6),
    _span("decode", 20, 40),
    _span("decode.tiles_in", 21, 4),
    _span("decode.kernel", 26, 24),
    _span("decode.tiles_out", 51, 8),
    _span("counters", 61, 36),
    _span("counters.read", 70, 26),
    _span("generator", 101, 1),
    _span("step", 103, 45),
    _span("decode", 105, 35),
    _span("decode.kernel", 106, 33),
    _span("counters", 141, 6),
    _span("counters.read", 142, 5.2),  # outlasts its parent by the clock's rounding
]
DEVICE = [
    _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),  # the draw
    _x("kernel", "randint", 7, 2, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=2),
    _x("kernel", "encode", 10, 8, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=3),
    _x("kernel", "gather", 22, 2, correlation=3),
    _x("cuda_runtime", "cudaGetDevice", 26, 1),  # no device row: not a launch
    _x("cuda_runtime", "cudaLaunchKernel", 27, 1, correlation=4),
    _x("kernel", "decode", 27, 28, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=5),
    _x("kernel", "codeword", 56, 2, correlation=5),
    # a copy to pageable memory returns when done: the host waits in it
    _x("cuda_runtime", "cudaMemcpyAsync", 71, 3, correlation=6),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 72, 1, correlation=6),
    _x("cuda_runtime", "cudaStreamSynchronize", 74, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 107, 1, correlation=7),
    _x("kernel", "decode", 107, 23, correlation=7),
    _x("cuda_runtime", "cudaMemcpyAsync", 143, 0.5, correlation=8),
    _x("gpu_memcpy", "Memcpy DtoD", 143, 1, correlation=8),  # no host side
    _x("cuda_runtime", "cudaStreamSynchronize", 143.5, 1.5),
]


def _trace(*parts):
    return {"traceEvents": [e for part in parts for e in part]}


def test_rows_syncs_launches_and_gaps_by_innermost_span():
    p = program_trace.reduce(_trace(RANGES, SPANS, DEVICE))
    us = pytest.approx
    assert p.steps == 2
    assert p.window_s == us(150e-6)
    assert p.busy_s == us((2 + 8 + 2 + 28 + 2 + 1 + 23 + 1) * 1e-6)
    assert p.device_s == {"draw": us(2e-6), "encode": us(8e-6), "decode.tiles_in": us(2e-6),
                          "decode.kernel": us(51e-6), "decode.tiles_out": us(2e-6),
                          "counters.read": us(2e-6)}
    assert p.glue_s == us(4e-6)  # the gather and the codeword, not the decode
    assert p.syncs == {"counters.read": 3}
    assert p.launches == {"draw": 1, "encode": 1, "decode.tiles_in": 1, "decode.kernel": 2,
                          "decode.tiles_out": 1, "counters.read": 2}
    assert (p.sweep_syncs, p.sweep_launches) == (3, 8)
    assert p.host_s == us((94 + 45 + 2 + 1) * 1e-6)
    assert p.host_sync_s == us((3 + 1 + 1.5) * 1e-6)
    # gaps: 0-7 before any span; 9-10 in the encode; 18-22 in the step;
    # 24-27 in the tiling; 55-56 and 58-72 in the output; 73-107 while the
    # copy waits; 130-143 in the second kernel span; 144-150 in the wait
    assert p.idle_sync_s == {"counters.read": us(40e-6)}
    assert p.idle_launch_s == {"outside": us(7e-6), "encode": us(1e-6), "step": us(4e-6),
                               "decode.tiles_in": us(3e-6), "decode.tiles_out": us(15e-6),
                               "decode.kernel": us(13e-6)}
    idle = sum(p.idle_sync_s.values()) + sum(p.idle_launch_s.values())
    assert idle == us(p.window_s - p.busy_s)


def test_per_step_numbers():
    p = program_trace.reduce(_trace(RANGES, SPANS, DEVICE))
    n = program_trace.per_step(p)
    assert n == {
        "syncs_per_step": 1.5,
        "launches_per_step": 4.0,
        "host_issue_ms": pytest.approx((142 - 5.5) * 1e-3 / 2),
        "idle_sync_ms": pytest.approx(40e-3 / 2),
        "idle_launch_ms": pytest.approx(43e-3 / 2),
        "decode_glue_ms": pytest.approx(4e-3 / 2),
    }
    s = trace.reduce(_trace(RANGES, SPANS, DEVICE))
    assert p.busy_s == pytest.approx(s.busy_s)
    assert n["idle_sync_ms"] + n["idle_launch_ms"] == pytest.approx(
        1e3 * (s.window_s - s.busy_s) / p.steps)
    assert n["decode_glue_ms"] < 1e3 * s.device_s["decode"] / p.steps


def test_nothing_to_read():
    assert program_trace.per_step(program_trace.reduce(_trace(SPANS, DEVICE))) == {}
    no_rows = program_trace.reduce(_trace(RANGES, SPANS))
    assert no_rows.steps == 2 and program_trace.per_step(no_rows) == {}
    assert program_trace.tile_useful_pct(100, 0, 4) is None
    assert program_trace.tile_useful_pct(90, 30, 4) == pytest.approx(75.0)


def test_table_lists_spans_in_step_order():
    p = program_trace.reduce(_trace(RANGES, SPANS, DEVICE))
    lines = program_trace.table(p, 2).splitlines()
    assert [line.split()[0] for line in lines[1:]] == [
        "step", "draw", "encode", "decode.tiles_in", "decode.kernel",
        "decode.tiles_out", "counters.read", "outside"]
    assert lines[-2].split()[1:] == ["0.001", "0.020", "0.000", "1.50", "1.00"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_reduce_is_unmoved_by_program_rows(seed):
    """The program's rows, put among the others at random places (the
    others keep their order), change nothing ``trace.reduce`` returns."""
    events = RANGES + DEVICE
    plain = trace.reduce({"traceEvents": events})
    rng = random.Random(seed)
    for span in SPANS:
        events = list(events)
        events.insert(rng.randrange(len(events) + 1), span)
    assert trace.reduce({"traceEvents": events}) == plain


def test_program_trace_loads_no_jax():
    tops = _loaded("import sys; sys.path.insert(0, '.'); import portbench.program_trace")
    assert not tops & JAX
