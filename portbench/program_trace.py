"""The program's own spans in a profiler's Chrome trace: which layer of the
port the host was in when it launched each device row, when it waited,
and when the device went idle.

The port marks its layers with ``ldpc.*`` spans (``ldpc_toolbox_torch/
telemetry.py``), which nest: ``ldpc.step`` holds ``ldpc.decode``, which
holds ``ldpc.decode.kernel``. ``reduce`` reads the same exported trace
as ``trace.reduce``, over the same window (the first ``pb.step`` range's
start to the last one's end), and gives each device row, each
synchronising runtime call and each idle gap the innermost program span
open on the host at its launch, its start or the gap's start ("outside"
when none is). ``trace.reduce``'s own lookup looks back over a few
ranges only, and the program's spans nest deeper, so this is a sweep of
its own.

A synchronising call is a runtime call in which the host waits for the
device: a stream, device or event synchronize or a blocking copy
(``SYNCS``), or a copy between the device and the host's pageable memory
(its device row says ``Pageable``), which the runtime stages through
pinned memory and which, to the host, returns only when done. PyTorch's
blocking copy (``torch.as_tensor(array, device=...)``, ``.tolist()``) is
two such calls: the copy and a stream synchronize after it. A launch is a
runtime call whose correlation id has a device row (kernel, memcpy,
memset). An idle gap is a sync gap when it began while the host was in a
synchronising call, else a launch gap: the device drained its queue
while the host was still issuing. The two kinds split the window's idle
time, ``window_s - busy_s``, exactly.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

from ldpc_toolbox_torch.telemetry import PREFIX

from .trace import _DEVICE_ROWS, _LAUNCHES
from .trace import PREFIX as RANGES

__all__ = ["ORDER", "SYNCS", "Program", "per_step", "reduce", "table", "tile_useful_pct"]

#: runtime and driver calls in which the host waits for the device, by
#: name; a copy to or from pageable memory waits too, whatever its name
SYNCS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
})
#: the spans whose time is the step's: the host's whole share of a step
SWEEP = ("step", "generator")
#: the program's spans in the order of a step, for ``table``
ORDER = ("generator", "step", "draw", "encode", "channel", "decode", "decode.tiles_in",
         "decode.kernel", "decode.tiles_out", "counters", "counters.read")
OUTSIDE = "outside"


@dataclass
class Program:
    """The reduction of a trace by the program's spans; each dict is keyed
    by the innermost span's name without ``ldpc.`` (or ``OUTSIDE``)."""

    steps: int = 0  # ldpc.step spans
    busy_s: float = 0.0
    window_s: float = 0.0
    device_s: dict = field(default_factory=dict)  # launched in the span: device seconds
    idle_sync_s: dict = field(default_factory=dict)  # gaps begun in a sync call there
    idle_launch_s: dict = field(default_factory=dict)  # the other gaps begun there
    syncs: dict = field(default_factory=dict)  # synchronising calls begun there
    launches: dict = field(default_factory=dict)  # launches made there
    glue_s: float = 0.0  # device seconds under ldpc.decode, not under ldpc.decode.kernel
    sweep_syncs: int = 0  # synchronising calls under ldpc.step or ldpc.generator
    sweep_launches: int = 0  # launches under them
    host_s: float = 0.0  # host seconds in ldpc.step and ldpc.generator
    host_sync_s: float = 0.0  # of which in synchronising calls


class _Spans:
    """The innermost open span, with the spans around it, at any time;
    spans of one thread nest (a child that outlasts its parent by the
    clock's rounding is cut at the parent's end)."""

    def __init__(self, spans):
        self.times, self.paths = [], []
        stack = []  # (end, path)
        for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][0] <= start:
                self._pop(stack)
            if stack:
                end = min(end, stack[-1][0])
            path = (stack[-1][1] if stack else ()) + (name,)
            stack.append((end, path))
            self._mark(start, path)
        while stack:
            self._pop(stack)

    def _pop(self, stack):
        end, _ = stack.pop()
        self._mark(end, stack[-1][1] if stack else ())

    def _mark(self, t, path):
        self.times.append(t)
        self.paths.append(path)

    def at(self, t):
        """The path of spans open at ``t``, outermost first; () outside."""
        i = bisect.bisect_right(self.times, t) - 1
        return self.paths[i] if i >= 0 else ()


def _name(path):
    return path[-1] if path else OUTSIDE


def _in_sweep(path):
    return bool(path) and path[0] in SWEEP


def reduce(trace: dict) -> Program:
    """The program's reduction of a Chrome trace (``export_chrome_trace``'s
    JSON) over ``trace.reduce``'s window."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    out = Program()
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == RANGES + "step"]
    if not steps:
        return out
    w0 = min(float(e["ts"]) for e in steps)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    out.window_s = (w1 - w0) * 1e-6
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX)]
    out.steps = sum(1 for s in spans if s[2] == "step")
    program = _Spans(spans)
    for start, end, name in spans:
        if name in SWEEP:
            out.host_s += (end - start) * 1e-6

    rows = [(float(e["ts"]), float(e["dur"]), e.get("args", {}).get("correlation"))
            for e in events if e.get("cat") in _DEVICE_ROWS]
    correlated = {corr for _, _, corr in rows if corr is not None}
    pageable = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in _DEVICE_ROWS and "Pageable" in e["name"]}
    runtime = [e for e in events if e.get("cat") in _LAUNCHES]
    launched = {}
    waits = []  # (start, end) of the synchronising calls
    syncs, launches = defaultdict(int), defaultdict(int)
    for e in runtime:
        ts = float(e["ts"])
        path = program.at(ts)
        corr = e.get("args", {}).get("correlation")
        if corr in correlated:
            launched[corr] = path
            launches[_name(path)] += 1
            out.sweep_launches += _in_sweep(path)
        if e["name"] in SYNCS or (corr is not None and corr in pageable):
            waits.append((ts, ts + float(e["dur"])))
            syncs[_name(path)] += 1
            if _in_sweep(path):
                out.sweep_syncs += 1
                out.host_sync_s += float(e["dur"]) * 1e-6
    out.syncs, out.launches = dict(syncs), dict(launches)
    waits.sort()
    wait_starts = [w[0] for w in waits]

    def waiting(t):
        i = bisect.bisect_right(wait_starts, t) - 1
        return i >= 0 and t <= waits[i][1]

    device = defaultdict(float)
    intervals = []
    for ts, dur, corr in rows:
        start, end = max(ts, w0), min(ts + dur, w1)
        if end <= start:
            continue
        seconds = (end - start) * 1e-6
        path = launched.get(corr, ())
        device[_name(path)] += seconds
        if "decode" in path and "decode.kernel" not in path:
            out.glue_s += seconds
        intervals.append((start, end))
    out.device_s = dict(device)

    # the busy and idle sweep of trace.reduce, each gap labelled by the
    # program span open and by whether the host waited as it began
    intervals.sort()
    idle = {True: defaultdict(float), False: defaultdict(float)}

    def gap(t0, t1):
        idle[waiting(t0)][_name(program.at(t0))] += (t1 - t0) * 1e-6

    cursor = w0
    for start, end in intervals:
        if start > cursor:
            gap(cursor, start)
        if end > cursor:
            out.busy_s += (end - max(start, cursor)) * 1e-6
            cursor = end
    if w1 > cursor:
        gap(cursor, w1)
    out.idle_sync_s, out.idle_launch_s = dict(idle[True]), dict(idle[False])
    return out


def per_step(p: Program) -> dict:
    """The sweep's and the device's numbers a step (an ``ldpc.step``):
    ``syncs_per_step``, ``launches_per_step``, ``host_issue_ms``,
    ``idle_sync_ms``, ``idle_launch_ms``, ``decode_glue_ms``; empty when
    the trace has no step or no device row."""
    if not p.steps or not p.busy_s:
        return {}
    n = p.steps
    return {
        "syncs_per_step": p.sweep_syncs / n,
        "launches_per_step": p.sweep_launches / n,
        "host_issue_ms": 1e3 * (p.host_s - p.host_sync_s) / n,
        "idle_sync_ms": 1e3 * sum(p.idle_sync_s.values()) / n,
        "idle_launch_ms": 1e3 * sum(p.idle_launch_s.values()) / n,
        "decode_glue_ms": 1e3 * p.glue_s / n,
    }


def tile_useful_pct(total_iterations: int, tile_iterations: int, bt: int):
    """100 x the frames' iterations over the iterations their tiles ran (BT
    frames a tile), None when no tile ran."""
    if not tile_iterations:
        return None
    return 100.0 * total_iterations / (bt * tile_iterations)


def table(p: Program, per: int) -> str:
    """A table by program span, each number over ``per`` (steps or
    decodes): device ms, idle ms in sync and launch gaps, synchronising
    calls and launches."""
    names = set(p.device_s) | set(p.idle_sync_s) | set(p.idle_launch_s) | set(p.syncs) \
        | set(p.launches)
    order = [n for n in ORDER if n in names] + sorted(names - set(ORDER))
    lines = [f"{'span':<18}{'device ms':>11}{'idle sync':>11}{'idle launch':>13}"
             f"{'syncs':>8}{'launches':>10}"]
    for n in order:
        lines.append(
            f"{n:<18}{1e3 * p.device_s.get(n, 0.0) / per:>11.3f}"
            f"{1e3 * p.idle_sync_s.get(n, 0.0) / per:>11.3f}"
            f"{1e3 * p.idle_launch_s.get(n, 0.0) / per:>13.3f}"
            f"{p.syncs.get(n, 0) / per:>8.2f}{p.launches.get(n, 0) / per:>10.2f}")
    return "\n".join(lines)
