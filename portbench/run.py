"""The benchmark's command: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root on a machine with as many CUDA devices as
the cell asks for. Prints the result as one JSON object, the last line of
standard output, and the numbers the check compared, each with its limit,
as the last lines of standard error. Exits non-zero without a result when
there is no such device, or when JAX or the JAX package was loaded.

The port builds its kernels into ``ldpc_toolbox_torch/build/`` in the
checkout (the first run of a cell compiles); nvcc's scratch goes to
``TMPDIR``. Python's bytecode of every module the run imports, torch's
too, is kept in ``portbench/build/pycache/`` in the checkout, whatever
the environment says, so that only the first run compiles those sources.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "portbench" / "build" / "pycache")

import argparse  # noqa: E402
import json  # noqa: E402

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness, lookup  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = ROOT / "BENCHMARK.json"
    cell = lookup.load_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
