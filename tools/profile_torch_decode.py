"""Where the device time of a port decode goes, by kernel, on one GPU.

    python3 tools/profile_torch_decode.py --decoder Minsumbf16 [--streaming]

Runs ``Decoder(DVB-S2 R1_2, decoder).decode_batch`` (B = 1024, channel
LLRs at 1.0 dB, at most 30 iterations by default) once to warm up, then
``--reps`` times under ``torch.profiler`` (CPU and CUDA activities), and
prints the card (``nvidia-smi`` name and power limit), the device time a
decode of each kernel and memory operation (host-side operator rows left
out, so nothing counts twice), their sum, the wall time a decode and the
device's idle share (1 - busy / wall; it exits non-zero if busy exceeds
wall, which means a row was counted twice). ``--streaming``
profiles the streaming path of the decoder's schedule
(``lifted_flooding_decode`` or ``lifted_layered_decode`` with
``resident=False``; every name) instead of the Decoder's resident one. The Chrome
trace goes to ``chiprun_out/``.
"""

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from ldpc_toolbox_torch.codes.dvbs2 import Code  # noqa: E402
from ldpc_toolbox_torch.decoder import Decoder, lifted_decode_for  # noqa: E402

#: rows printed by device time; the rest are summed on one line
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
        t0 = time.perf_counter()
        for _ in range(args.reps):
            decode()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.reps
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            continue  # host ops; their kernels are rows of their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / args.reps, ev.count // args.reps, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    path = "streaming" if args.streaming else "Decoder.decode_batch"
    print(f"[{card}] {args.decoder} {path}: B={args.batch}, {args.ebn0} dB, "
          f"{args.iters} iterations at most, {args.reps} decodes profiled")
    for ms, count, name in rows[:TOP]:
        print(f"  {ms:10.3f} ms {100 * ms / busy:6.2f} %  x{count:<5} {name[:90]}")
    rest = sum(r[0] for r in rows[TOP:])
    print(f"  {rest:10.3f} ms {100 * rest / busy:6.2f} %  the other {len(rows[TOP:])} rows")
    # unclamped: busy above wall means rows were counted twice, and
    # shows as a negative idle share rather than as 0 %
    print(f"  device busy {busy:.3f} ms, wall {wall_ms:.3f} ms a decode, "
          f"idle {100 * (1 - busy / wall_ms):.2f} %")
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"trace_{args.decoder}_{path.split('.')[0]}_{args.ebn0}dB.json")
    )
    if busy > wall_ms:
        sys.exit("device busy time exceeds the wall time: rows counted twice")


if __name__ == "__main__":
    main()
