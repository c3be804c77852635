"""One run of a cell: set-up, the measured window of ``ber`` steps, the
check against the reference, and the result's line.

Set-up builds the ``BerTest`` as the port's ``ber`` subcommand does
(``cli.resolve_ber_code``, ``cli._systematic_perm_if_needed``,
``BerTestBuilder`` with the configuration's settings) and runs one step
at the cell's shape from a stream the window does not use, which loads
(the first time in a checkout: builds) the decoder's kernels. The window
then repeats ``BerTest.step(step_generator(seed, 0, i), sigma)`` for
i = 0, 1, ..., the body of ``BerTest.run``'s point loop, with the port's
own ``step_generator``, until ``seconds`` have passed; each step ends with
its counters on the host, so a host clock around it times the whole step.
It keeps the outputs of ``check.STEPS`` steps drawn from the seed
(reservoir sampling over all the steps) for ``check.py``, which draws
them again with the reference's copy of the seeding.

``memory_peak_bytes`` is the card's peak less what the window keeps for
the check, which a deployment does not hold.

End-to-end metrics: ``info_mbps``, 1e-6 k frames over the window's
seconds, every step of the window counted (ber.rs:574); ``step_ms_p95``,
the 95th percentile of the steps' times; ``setup_s``, the process's start
to the window's. A traced run (``trace``) profiles the window and reports
the per-layer metrics instead (``metrics/``), read from the trace
(``trace.py``) and the steps' counters.
"""

from __future__ import annotations

import gc
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ldpc_toolbox_torch import cli
from ldpc_toolbox_torch.simulation.ber import step_generator
from ldpc_toolbox_torch.simulation.factory import BerTestBuilder, Modulation

from . import check, lookup, peaks, trace
from .reference import step as reference_step
from .reference.counters import NAMES

__all__ = ["FORBIDDEN", "build_test", "kept_bytes", "run_cell"]

#: top-level modules that may not be loaded in a run: JAX, and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_toolbox_tpu")


def build_test(config: dict, device):
    """The ``BerTest`` of a configuration, as ``ber`` builds it."""
    h, lifted = cli.resolve_ber_code(config["code"])
    perm, enc_h, encoder = cli._systematic_perm_if_needed(h, device)
    return BerTestBuilder(
        h=h,
        lifted_graph=lifted,
        modulation=Modulation.parse(config["modulation"]),
        decoder_implementation=config["decoder"],
        interleaving_columns=config.get("interleaving"),
        max_iterations=config["max_iter"],
        batch_size=config["batch_size"],
        device=device,
        systematic_permutation=perm,
        encoder_h=enc_h,
        prebuilt_encoder=encoder,
    ).build()


class _Window:
    def __init__(self):
        self.times = []
        self.totals = dict.fromkeys(NAMES, 0)
        self.kept = []
        self.seconds = 0.0


def _window(test, tap, sigma, seed, seconds, device, rng) -> _Window:
    w = _Window()
    t0 = time.perf_counter()
    end = t0
    i = 0
    while i == 0 or end - t0 < seconds:
        # reservoir sampling: every step is kept with the same chance
        slot = i if i < check.STEPS else rng.randrange(i + 1)
        tap.keep = {"step": i} if slot < check.STEPS else None
        start = time.perf_counter()
        with tap.range("step"):
            counters = test.step(step_generator(seed, 0, i, device), sigma)
            tap.end_step()
        end = time.perf_counter()
        if tap.keep is not None:
            tap.keep["counters"] = counters
            if slot < len(w.kept):
                w.kept[slot] = tap.keep
            else:
                w.kept.append(tap.keep)
        tap.keep = None
        w.times.append(end - start)
        for name in NAMES:
            w.totals[name] += counters[name]
        i += 1
    w.seconds = end - t0
    return w


def kept_bytes(kept) -> int:
    """The bytes of the device storage that the kept steps hold."""
    storages = {}
    for k in kept:
        for t in (k["msg"], k["cw"], k["llr"], *k["out"].values()):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values())


def _card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device) + ", power limit not read"


class _Context:
    """What a per-layer metric's reader may read."""

    def __init__(self, summary, window, reference, cell, root):
        self.device_s = summary.device_s if summary else {}
        self.busy_s = summary.busy_s if summary else 0.0
        self.window_s = summary.window_s if summary else window.seconds
        self.steps = len(window.times)
        self.totals = window.totals
        self.code = reference.code
        self.edges = reference.graph.E
        self.schedule = cell.config["reference"]["schedule"]
        self.roofline = lookup.roofline(cell.config["roofline"], root)
        self.peaks = peaks

    def range_ms(self, name):
        """Device milliseconds a step under ``pb.<name>``, None when the
        trace holds no device time."""
        if not self.busy_s:
            return None
        return 1e3 * self.device_s.get(name, 0.0) / self.steps


def _p95(values):
    return statistics.quantiles(values, n=20, method="inclusive")[18] if len(values) > 1 \
        else values[0]


def run_cell(bench_path, cell_name, seed, seconds, traced, t_start, device="cuda",
             root=lookup.HERE):
    """Runs a cell and returns its result (the line's object, its checks
    last). ``t_start``: the process's start on ``time.perf_counter``'s
    clock."""
    cell = lookup.load_cell(bench_path, cell_name, root)
    config, traffic = cell.config, cell.traffic
    device = torch.device(device)

    # -- set-up ------------------------------------------------------------
    marks = [time.perf_counter()]
    torch.zeros(1, device=device)  # the device's context
    marks.append(time.perf_counter())
    test = build_test(config, device)
    marks.append(time.perf_counter())
    sigma = test.noise_sigma(traffic["ebn0_db"])
    test.step(step_generator(seed, 1, 0, device), sigma)
    tap = trace.Tap(test, ranges=traced)
    marks.append(time.perf_counter())
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    setup_s = marks[-1] - t_start
    print("set-up: imports {:.3f} s, device context {:.3f} s, BerTest {:.3f} s, "
          "first step {:.3f} s".format(marks[0] - t_start, *np.diff(marks)), file=sys.stderr)

    # -- the window ----------------------------------------------------------
    rng = random.Random(seed)
    summary = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            window = _window(test, tap, sigma, seed, seconds, device, rng)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            summary = trace.reduce(json.loads(Path(path).read_text()))
        finally:
            os.remove(path)
        del prof
    else:
        window = _window(test, tap, sigma, seed, seconds, device, rng)
    # the window's steps run the warm step's shape; it holds the kept steps
    # besides (the peak falls in a step run while both are held)
    peak = setup_peak
    if device.type == "cuda":
        peak = max(peak, torch.cuda.max_memory_allocated(device) - kept_bytes(window.kept))
    card = _card(device)

    # -- the check, with the program's state freed ----------------------------
    batch = config["batch_size"]
    del tap, test
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_step.ReferenceStep(config, device)
    numbers = check.judge(
        window.kept, reference, lambda i: reference_step.step_generator(seed, 0, i, device),
        traffic["ebn0_db"], frames_short=len(window.times) * batch - window.totals["num_frames"])
    limits = config["limits"]

    # -- the result ------------------------------------------------------------
    if traced:
        ctx = _Context(summary, window, reference, cell, root)
        metrics = {}
        for m in cell.per_layer:
            value = lookup.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "info_mbps": 1e-6 * reference.code.k * window.totals["num_frames"] / window.seconds,
            "step_ms_p95": 1e3 * _p95(window.times),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": check.correct(numbers, limits),
        "attempted": len(window.times),
        "failed": 0,
        "metrics": metrics,
        "device": dev,
    }
    if traced:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {name: {"value": numbers[name], "limit": limits[name]}
                        for name in check.NUMBERS}
    print(f"{card}; {len(window.times)} steps, checked {[k['step'] for k in window.kept]}",
          file=sys.stderr)
    return result


def forbidden_modules():
    """The loaded modules whose top-level name is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
