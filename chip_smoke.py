"""Smoke run of ldpc_toolbox_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from the checkout's sources, holds it bit for bit
against its plain PyTorch version, drives the flagship decode through
``Decoder(...).decode_batch`` (DVB-S2 rate 1/2, n = 64800, HLMinsumbf16,
B = 1024, 1.0 dB, at most 30 iterations) and a two-point BER sweep through
``BerTestBuilder``, and prints times measured with CUDA events. The last
line of standard output is a JSON object with "ok": true; any failure
raises and exits non-zero, as does a machine without a CUDA device.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ldpc_toolbox_tpu.codes.dvbs2 import Code
from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
from ldpc_toolbox_torch.decoder import Decoder
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted import (
    LiftedGraph,
    lifted_graph_for,
    nr5g_maps,
)
from ldpc_toolbox_torch.decoder.lifted_layered import (
    lifted_layered_decode,
    plain_layered_decode,
    tile_inputs,
)
from ldpc_toolbox_torch.ops import _build
from ldpc_toolbox_torch.ops.resident_layered import (
    resident_layered_decode,
    resident_layered_decode_reference,
)
from ldpc_toolbox_torch.simulation import BerTestBuilder

DECODERS = ["HLMinsumf32", "HLMinsumbf16", "HLNormminsumbf16"]
FLAGSHIP_DECODER = "HLMinsumbf16"
FLAGSHIP_BATCH = 1024
FLAGSHIP_EBN0 = 1.0
FLAGSHIP_ITERS = 30


def sigma_at(code, ebn0_db):
    return float(np.sqrt(0.5 / (code.k / code.n * 10 ** (0.1 * ebn0_db))))


def channel_llrs(n, batch, sigma, seed):
    """All-zero codeword over BPSK + AWGN, as bench.py makes them."""
    rng = np.random.default_rng(seed)
    x = -1.0 + sigma * rng.standard_normal((batch, n), dtype=np.float32)
    return torch.from_numpy((-2.0 / sigma**2) * x).cuda()


def cuda_ms(fn, reps):
    """Median of ``reps`` timings of fn() in milliseconds, CUDA events,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_diff(xs, ys):
    return max(
        int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in zip(xs, ys)
    )


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build the kernel from the checkout's sources
    t0 = time.perf_counter()
    lib = _build.library_path("resident_layered")
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    # 2. the kernel against its plain version on the card, bit for bit
    bg2 = LiftedGraph.from_sparse(
        BaseGraph.BG2.h(16), *nr5g_maps(BaseGraph.BG2, 16)
    )
    short = lifted_graph_for(Code.R1_4short)
    flagship = lifted_graph_for(Code.R1_2)
    cases = [
        ("5G BG2 z=16", bg2, 256, 1.3, 10),
        ("DVB-S2 R1_4short", short, 128, 1.05, 8),
        ("DVB-S2 R1_2", flagship, 128, sigma_at(Code.R1_2, 1.5), 30),
    ]
    worst = 0
    for label, lg, batch, sigma, iters in cases:
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        for name in DECODERS:
            args = tile_inputs(lg, make_arithmetic(name)[1], llrs)
            out = resident_layered_decode(*args, iters)
            ref = resident_layered_decode_reference(*args, iters)
            torch.cuda.synchronize()
            err = max_abs_diff(out, ref)
            worst = max(worst, err)
            print(f"kernel vs plain: {label} B={batch} {name}: "
                  f"{int(out[2].sum())}/{out[2].numel()} converged, "
                  f"max abs diff {err} (tolerance 0)")
            assert err == 0, f"kernel differs from its plain version: {label} {name}"
    llrs = channel_llrs(bg2.n, 130, 1.3, seed=11)
    _, arith = make_arithmetic("HLMinsumbf16")
    out = lifted_layered_decode(bg2, arith, llrs, 10)
    ref = plain_layered_decode(bg2, arith, llrs, 10)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], ref[key]), f"partial tile: {key} differs"
    print(f"kernel vs plain: 5G BG2 z=16 B=130 (partial tile) HLMinsumbf16: "
          f"{int(out['success'].sum())}/130 converged, equal")

    # 3. the main path: the flagship decode through Decoder.decode_batch
    code = Code.R1_2
    dec = Decoder(code, FLAGSHIP_DECODER, device="cuda")
    llrs = channel_llrs(code.n, FLAGSHIP_BATCH, sigma_at(code, FLAGSHIP_EBN0), seed=0)
    resident_layered_decode.launches = 0
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    launches = resident_layered_decode.launches
    assert launches > 0, "the main path did not launch the kernel"
    ref = plain_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS)
    keys = ("codeword", "iterations", "success")
    worst = max(worst, max_abs_diff([out[k] for k in keys], [ref[k] for k in keys]))
    for key in keys:
        assert torch.equal(out[key], ref[key]), f"flagship: {key} differs"
    assert out["codeword"].shape == (FLAGSHIP_BATCH, code.n)
    iters = out["iterations"]
    print(f"flagship decode: {launches} kernel launch(es), output equal to the "
          f"plain version (tolerance 0), "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, "
          f"average iterations {float(iters.float().mean()):.2f}")

    def decode():
        dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)

    def plain_decode():
        plain_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS)

    executed = int(iters.max())
    decode_ms = cuda_ms(decode, 5)
    plain_decode_ms = cuda_ms(plain_decode, 3)
    args = tile_inputs(dec.lifted, dec.arithmetic, llrs)
    kernel_ms = cuda_ms(lambda: resident_layered_decode(*args, FLAGSHIP_ITERS), 5)
    plain_ms = cuda_ms(
        lambda: resident_layered_decode_reference(*args, FLAGSHIP_ITERS), 3
    )
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    plain_mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (plain_decode_ms * 1e-3)
    print(f"[{card}] flagship Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, {decode_ms / executed:.3f} ms/iter "
          f"({executed} iterations executed), median of 5")
    print(f"[{card}] flagship plain decode: {plain_decode_ms:.3f} ms, "
          f"{plain_mbps:.1f} Mbit/s, {plain_decode_ms / executed:.3f} ms/iter, "
          f"median of 3")
    print(f"[{card}] resident_layered_decode kernel: {kernel_ms:.3f} ms "
          f"({kernel_ms / executed:.3f} ms/iter); plain version {plain_ms:.3f} ms "
          f"({plain_ms / executed:.3f} ms/iter)")

    # 4. a BER sweep through the port's BerTestBuilder
    test = BerTestBuilder(
        h=code.h(), lifted_graph=dec.lifted,
        decoder_implementation=FLAGSHIP_DECODER, max_frame_errors=2000,
        max_run_time=6.0, max_iterations=FLAGSHIP_ITERS, ebn0s_db=[0.5, 2.0],
        batch_size=FLAGSHIP_BATCH, seed=0, device="cuda",
    ).build()
    low, high = test.run()
    for s in (low, high):
        print(f"[{card}] ber {s.ebn0_db} dB: {s.num_frames} frames, FER "
              f"{s.ldpc.fer:.3e}, BER {s.ldpc.ber:.3e}, average iterations "
              f"{s.average_iterations:.2f}, {s.throughput_mbps:.1f} Mbit/s")
        assert s.num_frames >= FLAGSHIP_BATCH
    assert low.ldpc.fer >= 0.9, f"FER at 0.5 dB is {low.ldpc.fer}"
    assert high.ldpc.fer <= 0.01, f"FER at 2.0 dB is {high.ldpc.fer}"

    print(json.dumps({"kernels": [{
        "name": "resident_layered_decode",
        "route": "cuda",
        "source": "ldpc_toolbox_torch/csrc/resident_layered.cu",
        "replaces": "ldpc_toolbox_tpu/ops/resident_layered.py:193",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
