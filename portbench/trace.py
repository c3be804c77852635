"""Ranges around a step's layers, and the reduction of the profiler's
trace to device time by range, busy time and idle gaps.

A traced run wraps the window in ``torch.profiler.profile`` and each step
in ``pb.step``; ``Tap`` wraps the step's calls into the layers,
``BerTest.encode`` (``pb.encode``), ``BerTest.channel_llrs``
(``pb.channel``), the decode (``pb.decode``), and the rest of the step
after the decode, the counters (``pb.counters``). ``reduce`` reads the
exported Chrome trace: each device row (kernel, memcpy, memset) belongs
to the innermost range open on the host when it was launched (found by
its correlation id); ``pb.step`` alone is the message draw. Busy time is
the union of the device rows over the traced window, the first step's
start to the last step's end; an idle gap is labelled by the range open
on the host when the device went idle.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch

__all__ = ["PREFIX", "Summary", "Tap", "reduce"]

PREFIX = "pb."
_DEVICE_ROWS = {"kernel", "gpu_memcpy", "gpu_memset"}
_LAUNCHES = {"cuda_runtime", "cuda_driver"}


class Tap:
    """Wraps a ``BerTest``'s encode, channel and decode on the instance:
    records what a kept step produces (``keep``, a dict, or None) and, with
    ``ranges``, opens a profiler range around each call."""

    def __init__(self, test, ranges: bool):
        self.keep = None
        self.ranges = ranges
        self._tail = None
        encode, channel, decode = test.encode, test.channel_llrs, test.decode

        def tapped_encode(msg):
            with self.range("encode"):
                cw = encode(msg)
            if self.keep is not None:
                self.keep.update(msg=msg, cw=cw)
            return cw

        def tapped_channel(cw, noise_sigma, generator):
            with self.range("channel"):
                return channel(cw, noise_sigma, generator)

        def tapped_decode(graph, arithmetic, llr, max_iterations):
            with self.range("decode"):
                out = decode(graph, arithmetic, llr, max_iterations)
            if self.keep is not None:
                self.keep.update(llr=llr, out=out)
            if self.ranges:
                self._tail = torch.profiler.record_function(PREFIX + "counters")
                self._tail.__enter__()
            return out

        test.encode, test.channel_llrs, test.decode = (
            tapped_encode, tapped_channel, tapped_decode)

    def range(self, name):
        if not self.ranges:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def end_step(self):
        """Closes the counters' range the decode opened."""
        if self._tail is not None:
            self._tail.__exit__(None, None, None)
            self._tail = None


@dataclass
class Summary:
    device_s: dict = field(default_factory=dict)  # range -> device seconds
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)  # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)  # [[label, seconds]]


class _Ranges:
    """Innermost-range lookup over the host's nested ranges."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        # ranges nest within a step, so the innermost open one is among the
        # last few that started
        for j in range(i, max(i - 8, -1), -1):
            start, end, name = self.ranges[j]
            if start <= t <= end:
                return name
        return "outside"


def reduce(trace: dict, top: int = 10, name_chars: int = 120) -> Summary:
    """The summary of a Chrome trace (``export_chrome_trace``'s JSON);
    device operations named by their first ``name_chars`` characters."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
              for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(PREFIX)]
    steps = [r for r in ranges if r[2] == "step"]
    out = Summary()
    if not steps:
        return out
    w0, w1 = min(r[0] for r in steps), max(r[1] for r in steps)
    out.window_s = (w1 - w0) * 1e-6
    lookup = _Ranges(ranges)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in _LAUNCHES and "correlation" in e.get("args", {})}
    rows = [(float(e["ts"]), float(e["dur"]), e["name"], e.get("args", {}).get("correlation"))
            for e in events if e.get("cat") in _DEVICE_ROWS]
    device = defaultdict(float)
    by_name = defaultdict(float)
    intervals = []
    for ts, dur, name, corr in rows:
        start, end = max(ts, w0), min(ts + dur, w1)
        if end <= start:
            continue
        seconds = (end - start) * 1e-6
        t = launched.get(corr)
        device["outside" if t is None else lookup.at(t)] += seconds
        by_name[name[:name_chars]] += seconds
        intervals.append((start, end))
    out.device_s = dict(device)
    out.device_ops = [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]]
    intervals.sort()
    busy = 0.0
    gaps = defaultdict(lambda: [0.0, 0])
    cursor = w0
    for start, end in intervals:
        if start > cursor:
            label = gaps[lookup.at(cursor)]
            label[0] += (start - cursor) * 1e-6
            label[1] += 1
        if end > cursor:
            busy += (end - max(start, cursor)) * 1e-6
            cursor = end
    if w1 > cursor:
        label = gaps[lookup.at(cursor)]
        label[0] += (w1 - cursor) * 1e-6
        label[1] += 1
    out.busy_s = busy
    out.idle_gaps = [[f"{name}: {n} gaps", s] for name, (s, n) in
                     sorted(gaps.items(), key=lambda x: -x[1][0])[:top]]
    return out
