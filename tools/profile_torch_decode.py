"""Where the device time of a port decode goes, by kernel and by the
decode's own spans, on one GPU.

    python3 tools/profile_torch_decode.py --decoder Minsumbf16 [--streaming]

Runs ``Decoder(DVB-S2 R1_2, decoder).decode_batch`` (B = 1024, channel
LLRs at 1.0 dB, at most 30 iterations by default) once to warm up, then
``--reps`` times under ``torch.profiler`` (CPU and CUDA activities), each
decode and a synchronize in a ``pb.step`` range, and reduces the Chrome
trace as the benchmark does (``portbench/trace.reduce``: device rows only,
so nothing counts twice; busy time over the window of the ranges; idle
unclamped) and by the port's spans (``portbench/program_trace.reduce``).
Prints the card (``nvidia-smi`` name and power limit), the device time a
decode of the top kernels and memory operations, the busy and wall time a
decode and the device's idle share (it exits non-zero if busy exceeds
wall, which means a row was counted twice), and the decode's split by its
``ldpc.decode.*`` spans: the tiling, the kernel and the output, with idle
time, synchronising calls and launches. ``--streaming`` profiles the
streaming path of the decoder's schedule (``lifted_flooding_decode`` or
``lifted_layered_decode`` with ``resident=False``; every name) instead of
the Decoder's resident one. The Chrome trace goes to ``chiprun_out/``.
"""

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from ldpc_toolbox_torch.codes.dvbs2 import Code  # noqa: E402
from ldpc_toolbox_torch.decoder import Decoder, lifted_decode_for  # noqa: E402
from portbench import program_trace, trace  # noqa: E402

#: kernels and memory operations printed by device time; the rest are summed
TOP = 12


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--decoder", default="Minsumbf16")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--ebn0", type=float, default=1.0)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--streaming", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    code = Code.R1_2
    dec = Decoder(code, args.decoder, device="cuda")
    sigma = float(np.sqrt(0.5 / (code.k / code.n * 10 ** (0.1 * args.ebn0))))
    rng = np.random.default_rng(0)
    x = -1.0 + sigma * rng.standard_normal((args.batch, code.n), dtype=np.float32)
    llrs = torch.from_numpy((-2.0 / sigma**2) * x).cuda()

    def decode():
        if args.streaming:
            return lifted_decode_for(dec.schedule)(
                dec.lifted, dec.arithmetic, llrs, args.iters, resident=False
            )
        return dec.decode_batch(llrs, max_iterations=args.iters)

    decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            with record_function(trace.PREFIX + "step"):
                decode()
                torch.cuda.synchronize()
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    path = "streaming" if args.streaming else "Decoder.decode_batch"
    name = out / f"trace_{args.decoder}_{path.split('.')[0]}_{args.ebn0}dB.json"
    prof.export_chrome_trace(str(name))
    data = json.loads(name.read_text())
    summary = trace.reduce(data, top=TOP)
    spans = program_trace.reduce(data)
    busy, wall = 1e3 * summary.busy_s / args.reps, 1e3 * summary.window_s / args.reps
    print(f"[{card}] {args.decoder} {path}: B={args.batch}, {args.ebn0} dB, "
          f"{args.iters} iterations at most, {args.reps} decodes profiled")
    for op, seconds in summary.device_ops:
        ms = 1e3 * seconds / args.reps
        print(f"  {ms:10.3f} ms {100 * ms / busy:6.2f} %  {op[:90]}")
    rest = busy - 1e3 * sum(s for _, s in summary.device_ops) / args.reps
    print(f"  {rest:10.3f} ms {100 * rest / busy:6.2f} %  the other rows")
    # unclamped: busy above wall means rows were counted twice, and
    # shows as a negative idle share rather than as 0 %
    print(f"  device busy {busy:.3f} ms, wall {wall:.3f} ms a decode, "
          f"idle {100 * (1 - busy / wall):.2f} %")
    print("  a decode by span (outside: the synchronize that ends it):")
    print("\n".join("    " + line for line in program_trace.table(spans, args.reps).splitlines()))
    if busy > wall:
        sys.exit("device busy time exceeds the wall time: rows counted twice")


if __name__ == "__main__":
    main()
