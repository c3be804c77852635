"""The readings that a cell's limits are set from: the program's and the
control's numbers of ``check.py`` on given seeds, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        [--program-seeds 1,2,...] [--fault NAME]

For each program seed it runs as many steps as a run keeps
(``check.STEPS``) through the program, as the window does, and judges
them; for each control seed it puts the control in the program's place
(the reference with the channel and the messages one precision lower,
``reference.step.ReferenceStep.control``) and judges that. One JSON line a
reading, then the largest program reading and the smallest control
reading of each number. ``--fault`` plants one of ``faults.FAULTS`` in the
program instead of reading it as it is. The benchmark's runs do not run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from ldpc_toolbox_torch.simulation.ber import step_generator  # noqa: E402
from portbench import check, faults, harness, lookup, trace  # noqa: E402
from portbench.reference.step import ReferenceStep  # noqa: E402
from portbench.reference.step import step_generator as reference_generator  # noqa: E402


def program_readings(cell, seeds, device, fault=None):
    """{seed: numbers} of the program's first steps on each seed."""
    config, ebn0 = cell.config, cell.traffic["ebn0_db"]
    test = harness.build_test(config, device)
    if fault:
        faults.plant(test, fault)
    sigma = test.noise_sigma(ebn0)
    tap = trace.Tap(test, ranges=False)
    kept = {}
    for seed in seeds:
        kept[seed] = []
        for i in range(check.STEPS):
            tap.keep = {"step": i}
            tap.keep["counters"] = test.step(step_generator(seed, 0, i, device), sigma)
            kept[seed].append(tap.keep)
    tap.keep = None
    del test, tap
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = ReferenceStep(config, device)
    return {seed: check.judge(k, reference, lambda i, s=seed: reference_generator(s, 0, i, device),
                              ebn0) for seed, k in kept.items()}


def control_readings(cell, seeds, device):
    """{seed: numbers} of the control on each seed."""
    config, ebn0 = cell.config, cell.traffic["ebn0_db"]
    reference = ReferenceStep(config, device)
    out = {}
    for seed in seeds:
        def gen(i, s=seed):
            return reference_generator(s, 0, i, device)

        kept = []
        for i in range(check.STEPS):
            k = reference.control(gen(i), ebn0)
            k["step"] = i
            kept.append(k)
        out[seed] = check.judge(kept, reference, gen, ebn0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--program-seeds", default="")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    cell = lookup.load_cell(ROOT / "BENCHMARK.json", args.workload)
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    program_seeds = [int(s) for s in args.program_seeds.split(",") if s]
    lower, upper = {}, {}
    t0 = time.perf_counter()
    for seed, numbers in program_readings(cell, program_seeds, device, args.fault).items():
        print(json.dumps({"side": args.fault or "program", "seed": seed, **numbers}), flush=True)
        for k, v in numbers.items():
            lower[k] = max(lower.get(k, v), v)
    t1 = time.perf_counter()
    for seed, numbers in control_readings(cell, seeds, device).items():
        print(json.dumps({"side": "control", "seed": seed, **numbers}), flush=True)
        for k, v in numbers.items():
            upper[k] = min(upper.get(k, v), v)
    t2 = time.perf_counter()
    print(json.dumps({"workload": args.workload, "largest_program": lower,
                      "smallest_control": upper, "limits": cell.config["limits"],
                      "program_s": t1 - t0, "control_s": t2 - t1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
