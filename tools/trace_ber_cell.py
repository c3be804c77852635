"""Where a benchmark cell's `ber` steps spend their time, by the port's own
spans, on one GPU.

    python3 tools/trace_ber_cell.py --workload <cell> [--seed N] [--seconds S]

Runs the cell's traced window as ``portbench/run.py --trace 1`` does
(set-up, one warm step, then ``BerTest.step`` under the benchmark's
``pb.*`` ranges for ``--seconds`` seconds, under ``torch.profiler``), with
the program's counts collected around the window
(``telemetry.counting()``). Reduces the exported Chrome trace twice: by
the benchmark's ranges (``portbench/trace.reduce``) and by the program's
``ldpc.*`` spans (``portbench/program_trace.reduce``). Prints the card
(``nvidia-smi`` name and power limit), the device ms a step by range, a
table by program span (device ms, idle ms in sync and in launch gaps,
synchronising calls and launches, a step), the step's numbers
(``program_trace.per_step``, ``tile_useful_pct``), the runtime calls a
step by name, and the checks that tie the two reductions together; exits
non-zero when one fails.
"""

import argparse
import json
import os
import pathlib
import random
import subprocess
import sys
import tempfile
from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ldpc_toolbox_torch import telemetry  # noqa: E402
from ldpc_toolbox_torch.ops.fused_bp2 import BT  # noqa: E402
from ldpc_toolbox_torch.simulation.ber import step_generator  # noqa: E402
from portbench import harness, lookup, program_trace, trace  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    cell = lookup.load_cell(ROOT / "BENCHMARK.json", args.workload)
    test = harness.build_test(cell.config, device)
    sigma = test.noise_sigma(cell.traffic["ebn0_db"])
    test.step(step_generator(args.seed, 1, 0, device), sigma)
    tap = trace.Tap(test, ranges=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with telemetry.counting() as counts:
            # the benchmark's own window loop, so the steps are its steps
            window = harness._window(test, tap, sigma, args.seed, args.seconds, device,
                                     random.Random(args.seed))
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        data = json.loads(pathlib.Path(path).read_text())
    finally:
        os.remove(path)
    steps = len(window.times)
    summary = trace.reduce(data)
    prog = program_trace.reduce(data)
    numbers = program_trace.per_step(prog)
    numbers["tile_useful_pct"] = program_trace.tile_useful_pct(
        window.totals["total_iterations"], counts.get("tile_iterations", 0), BT)
    idle_ms = 1e3 * (summary.window_s - summary.busy_s) / steps

    print(f"[{card}] {args.workload}: seed {args.seed}, {steps} steps in "
          f"{summary.window_s:.3f} s, busy {summary.busy_s:.3f} s, "
          f"idle {100 * (1 - summary.busy_s / summary.window_s):.2f} %")
    print("device ms a step by range: " + ", ".join(
        f"{n} {1e3 * s / steps:.3f}" for n, s in sorted(summary.device_s.items())))
    print(program_trace.table(prog, steps))
    for name, value in numbers.items():
        print(f"{name} = {value!r}")
    print(f"tile_iterations = {counts.get('tile_iterations')}, "
          f"total_iterations = {window.totals['total_iterations']}, "
          f"frames = {window.totals['num_frames']}")
    runtime = Counter(e["name"] for e in data["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"))
    print("runtime calls a step: " + ", ".join(
        f"{n} {c / steps:.2f}" for n, c in runtime.most_common()))
    checks = {
        "ldpc.step spans == steps": prog.steps == steps,
        "busy as trace.reduce": abs(prog.busy_s - summary.busy_s) <= 1e-9 * steps,
        "idle split sums to the idle": abs(
            numbers["idle_sync_ms"] + numbers["idle_launch_ms"] - idle_ms) <= 1e-3 * idle_ms,
        "decode_glue_ms < decode_ms": numbers["decode_glue_ms"]
        < 1e3 * summary.device_s.get("decode", 0.0) / steps,
        "syncs_per_step >= 1": numbers["syncs_per_step"] >= 1,
    }
    for name, ok in checks.items():
        print(f"check {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        sys.exit("a check failed")


if __name__ == "__main__":
    main()
