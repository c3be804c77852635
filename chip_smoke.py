"""Smoke run of ldpc_toolbox_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout's sources (one nvcc a source,
all at once), holds every kernel bit for bit against its plain PyTorch
version, and drives the port's two main paths on the flagship code
(DVB-S2 rate 1/2, n = 64800, B = 1024, 1.0 dB, at most 30 iterations):

1. the layered decode through ``Decoder(Code.R1_2, "HLMinsumbf16")``;
2. the flooding decode through ``Decoder(Code.R1_2, "Minsumbf16")`` (the
   resident kernel), and the same decode on the streaming path
   (``lifted_flooding_decode(..., resident=False)``, the phase kernels);

each with its launch counts set to 0 just before and read just after, and
a two-point BER sweep of each schedule through ``BerTestBuilder``. Times
are medians of CUDA-event timings. Before the last line it prints a JSON
line with every kernel's launches, worst difference from its plain
version, time, plain time and bound; the last line of standard output is
a JSON object with "ok": true. Any failure raises and exits non-zero, as
does a machine without a CUDA device.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ldpc_toolbox_torch.codes.ccsds import C2Code
from ldpc_toolbox_torch.codes.dvbs2 import Code
from ldpc_toolbox_torch.codes.nr5g import BaseGraph
from ldpc_toolbox_torch.decoder import Decoder
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.lifted import (
    LiftedGraph,
    lifted_graph_for,
    nr5g_maps,
)
from ldpc_toolbox_torch.decoder.lifted_flooding import (
    flooding_tiles,
    lifted_flooding_decode,
    streaming_flooding_decode,
)
from ldpc_toolbox_torch.decoder.lifted_layered import (
    lifted_layered_decode,
    plain_layered_decode,
    tile_inputs,
    tiles_to_output,
)
from ldpc_toolbox_torch.ops import _build
from ldpc_toolbox_torch.ops.fused_bp2 import (
    fused_check,
    fused_check_reference,
    fused_syndrome_bits,
    fused_syndrome_bits_reference,
    fused_var,
    fused_var_reference,
)
from ldpc_toolbox_torch.ops.resident_flooding import (
    resident_flooding_decode,
    resident_flooding_decode_reference,
)
from ldpc_toolbox_torch.ops.resident_layered import (
    resident_layered_decode,
    resident_layered_decode_reference,
)
from ldpc_toolbox_torch.simulation import BerTestBuilder

LAYERED = ["HLMinsumf32", "HLMinsumbf16", "HLNormminsumbf16"]
FLOODING = ["Minsumf32", "Minsumbf16", "Normminsumbf16"]
FLAGSHIP_BATCH = 1024
FLAGSHIP_EBN0 = 1.0
FLAGSHIP_ITERS = 30
R1_2_RATE = Code.R1_2.k / Code.R1_2.n
C2_RATE = 7154 / 8176  # nominal (CCSDS 131.0-B-5, Table 7-1)
#: H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM3 bytes/s
#: and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: operations a lane does, counted from the kernels' source: the min-sum
#: check fold and outputs per edge lane (+1 for the scale), the variable
#: rule's add and subtract per edge lane and its hard decision per
#: variable lane, the syndrome's xor per edge lane, and the layered
#: update's extrinsic and delta per edge lane (with its Qv add)
CHECK_OPS, VAR_EDGE_OPS, VAR_LANE_OPS, SYN_OPS, LAYERED_EXTRA_OPS = 11, 2, 1, 1, 3
PHASES = ("fused_check", "fused_var", "fused_syndrome_bits")


def sigma_at(rate, ebn0_db):
    """The BPSK noise sigma of an Eb/N0 at a code rate."""
    return float(np.sqrt(0.5 / (rate * 10 ** (0.1 * ebn0_db))))


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
    """Largest |x - y| over pairs of tensors of equal shape (floats
    compared in float64, so big and the bf16 values are exact)."""
    worst = 0.0
    for x, y in zip(xs, ys):
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time of the work on the
    card, the larger of the bytes over the memory rate and the operations
    over the f32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def tile_iterations(iters, bt):
    """Iterations each tile ran: a tile stops once its frames have all
    converged, so it runs as many as its slowest frame."""
    return iters.reshape(-1, bt).max(dim=1).values


def hold(worst, kernel, label, out, ref):
    """Fail unless a kernel's outputs equal its plain version's; keep the
    kernel's worst difference in ``worst``."""
    err = max_abs_diff(out, ref)
    worst[kernel] = max(worst[kernel], err)
    assert err == 0, f"{kernel} differs from its plain version: {label}"


def reset_counts():
    for fn in (resident_layered_decode, resident_flooding_decode, fused_check,
               fused_var, fused_syndrome_bits):
        fn.launches = 0


def build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(libs)} sources, "
          "one nvcc each, in parallel")
    for name, lib in libs.items():
        print(f"  {name}: {lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())


def test_graphs():
    bg2 = LiftedGraph.from_sparse(BaseGraph.BG2.h(16), *nr5g_maps(BaseGraph.BG2, 16))
    return {
        "5G BG2 z=16": bg2,
        "DVB-S2 R1_4short": lifted_graph_for(Code.R1_4short),
        "DVB-S2 R1_2": lifted_graph_for(Code.R1_2),
        "CCSDS C2": lifted_graph_for(C2Code()),
    }


def layered_checks(graphs):
    """The layered kernel against its plain version; worst difference."""
    cases = [
        ("5G BG2 z=16", 256, 1.3, 10),
        ("DVB-S2 R1_4short", 128, 1.05, 8),
        ("DVB-S2 R1_2", 128, sigma_at(R1_2_RATE, 1.5), 30),
    ]
    worst = 0.0
    for label, batch, sigma, iters in cases:
        lg = graphs[label]
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        for name in LAYERED:
            args = tile_inputs(lg, make_arithmetic(name)[1], llrs)
            out = resident_layered_decode(*args, iters)
            ref = resident_layered_decode_reference(*args, iters)
            torch.cuda.synchronize()
            err = max_abs_diff(out, ref)
            worst = max(worst, err)
            print(f"layered kernel vs plain: {label} B={batch} {name}: "
                  f"{int(out[2].sum())}/{out[2].numel()} converged, "
                  f"max abs diff {err} (tolerance 0)")
            assert err == 0, f"kernel differs from its plain version: {label} {name}"
    bg2 = graphs["5G BG2 z=16"]
    llrs = channel_llrs(bg2.n, 130, 1.3, seed=11)
    _, arith = make_arithmetic("HLMinsumbf16")
    out = lifted_layered_decode(bg2, arith, llrs, 10)
    ref = plain_layered_decode(bg2, arith, llrs, 10)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], ref[key]), f"partial tile: {key} differs"
    print(f"layered kernel vs plain: 5G BG2 z=16 B=130 (partial tile) "
          f"HLMinsumbf16: {int(out['success'].sum())}/130 converged, equal")
    return worst


def flooding_checks(graphs):
    """Each flooding kernel against its plain version on the same inputs,
    and the streaming path against the resident one; worst difference of
    each kernel."""
    cases = [
        ("5G BG2 z=16", 256, 1.3, 10),
        ("DVB-S2 R1_4short", 128, 0.85, 8),
        ("DVB-S2 R1_2", 128, sigma_at(R1_2_RATE, 1.5), 30),
        ("CCSDS C2", 128, sigma_at(C2_RATE, 4.0), 10),
    ]
    worst = dict.fromkeys(PHASES + ("resident_flooding_decode",), 0.0)
    for label, batch, sigma, iters in cases:
        lg = graphs[label]
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        for name in FLOODING:
            tag = f"{label} B={batch} {name}"
            q, bits0, layout, rule = flooding_tiles(lg, make_arithmetic(name)[1], llrs)
            v2c0 = fused_var(None, q, layout, rule)
            hold(worst, "fused_var", tag, v2c0, fused_var_reference(None, q, layout, rule))
            c2v = fused_check(v2c0[0], layout, rule)
            hold(worst, "fused_check", tag, [c2v], [fused_check_reference(v2c0[0], layout, rule)])
            v2c = fused_var(c2v, q, layout, rule)
            hold(worst, "fused_var", tag, v2c, fused_var_reference(c2v, q, layout, rule))
            for b in (bits0, v2c[1]):
                hold(worst, "fused_syndrome_bits", tag, [fused_syndrome_bits(b, layout)],
                     [fused_syndrome_bits_reference(b, layout)])
            args = (q, bits0, layout, rule, iters)
            out = resident_flooding_decode(*args)
            hold(worst, "resident_flooding_decode", tag, out,
                 resident_flooding_decode_reference(*args))
            stream = streaming_flooding_decode(*args)
            assert max_abs_diff(out, stream) == 0, f"streaming differs: {tag}"
            torch.cuda.synchronize()
            print(f"flooding kernels vs plain: {tag}: each phase and the "
                  f"resident decode equal (tolerance 0), streaming equals "
                  f"resident, {int(out[2].sum())}/{out[2].numel()} converged")
    bg2 = graphs["5G BG2 z=16"]
    llrs = channel_llrs(bg2.n, 130, 1.3, seed=11)
    _, arith = make_arithmetic("Minsumbf16")
    out = lifted_flooding_decode(bg2, arith, llrs, 10)
    stream = lifted_flooding_decode(bg2, arith, llrs, 10, resident=False)
    plain = lifted_flooding_decode(bg2, arith, llrs.cpu(), 10)
    for key in ("codeword", "iterations", "success"):
        assert torch.equal(out[key], stream[key]), f"partial tile: {key} differs"
        assert torch.equal(out[key].cpu(), plain[key]), f"partial tile: {key} differs"
    print(f"flooding kernels vs plain: 5G BG2 z=16 B=130 (partial tile) "
          f"Minsumbf16: {int(out['success'].sum())}/130 converged; resident, "
          "streaming and the plain versions on the CPU equal")
    return worst


def flagship_layered(card, llrs):
    """Main path 1: the layered decode; its kernel's entry."""
    code = Code.R1_2
    dec = Decoder(code, "HLMinsumbf16", device="cuda")
    reset_counts()
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    launches = resident_layered_decode.launches
    assert launches > 0, "the layered main path did not launch its kernel"
    ref = plain_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS)
    keys = ("codeword", "iterations", "success")
    err = max_abs_diff([out[k] for k in keys], [ref[k] for k in keys])
    assert err == 0, "flagship layered decode differs from the plain version"
    assert out["codeword"].shape == (FLAGSHIP_BATCH, code.n)
    iters = out["iterations"]
    print(f"flagship layered decode: {launches} kernel launch(es), output equal "
          f"to the plain version (tolerance 0), "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, "
          f"average iterations {float(iters.float().mean()):.2f}")

    executed = int(iters.max())
    decode_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    plain_decode_ms = cuda_ms(
        lambda: plain_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS), 3
    )
    args = tile_inputs(dec.lifted, dec.arithmetic, llrs)
    kernel_ms = cuda_ms(lambda: resident_layered_decode(*args, FLAGSHIP_ITERS), 5)
    plain_ms = cuda_ms(lambda: resident_layered_decode_reference(*args, FLAGSHIP_ITERS), 3)
    qv0, bits0, layout, _ = args
    nbt, VG, Z, Bt = qv0.shape
    lanes = VG * Z * Bt * nbt
    edge_tile = layout.E * Z * Bt
    tile_its = int(tile_iterations(iters, Bt).sum())
    ops = tile_its * edge_tile * (CHECK_OPS + LAYERED_EXTRA_OPS + SYN_OPS + 1)
    bound_ms, bound_by = bound(lanes * (4 + 1 + 1) + nbt * Bt * 8, ops)
    # per edge lane: Qv f32 read for x, read and written for the update and
    # read for the syndrome, Rcv bf16 read and written
    state_ms = 1e3 * tile_its * edge_tile * 20 / HBM_BYTES_PER_S
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    print(f"[{card}] flagship layered Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, {decode_ms / executed:.3f} ms/iter "
          f"({executed} iterations executed), median of 5")
    print(f"[{card}] flagship layered plain decode: {plain_decode_ms:.3f} ms, "
          f"{plain_decode_ms / executed:.3f} ms/iter, median of 3")
    print(f"[{card}] resident_layered_decode kernel: {kernel_ms:.3f} ms "
          f"({kernel_ms / executed:.3f} ms/iter); plain version {plain_ms:.3f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} (inputs and outputs once); "
          f"state-traffic floor {state_ms:.3f} ms ({tile_its} tile-iterations)")
    return dec.lifted, [{
        "name": "resident_layered_decode",
        "route": "cuda",
        "source": "ldpc_toolbox_torch/csrc/resident_layered.cu",
        "replaces": "ldpc_toolbox_tpu/ops/resident_layered.py:193",
        "launches": launches,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]


def flagship_flooding(card, llrs, worst):
    """Main path 2: the flooding decode, resident (through the Decoder) and
    streaming; each phase kernel against its plain version on the
    flagship's planes (worst differences into ``worst``); resident against
    streaming at 2.5 dB, where frames converge and freeze; the entries of
    its four kernels."""
    code = Code.R1_2
    dec = Decoder(code, "Minsumbf16", device="cuda")
    keys = ("codeword", "iterations", "success")
    reset_counts()
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    resident_launches = resident_flooding_decode.launches
    assert resident_launches > 0, "the flooding main path did not launch its kernel"
    tiles = flooding_tiles(dec.lifted, dec.arithmetic, llrs)
    ref = tiles_to_output(
        dec.lifted, *resident_flooding_decode_reference(*tiles, FLAGSHIP_ITERS),
        FLAGSHIP_BATCH,
    )
    err = max_abs_diff([out[k] for k in keys], [ref[k] for k in keys])
    assert err == 0, "flagship flooding decode differs from the plain version"
    assert out["codeword"].shape == (FLAGSHIP_BATCH, code.n)

    reset_counts()
    stream = lifted_flooding_decode(
        dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS, resident=False
    )
    torch.cuda.synchronize()
    phase_launches = {f.__name__: f.launches for f in
                      (fused_check, fused_var, fused_syndrome_bits)}
    assert all(phase_launches.values()), f"streaming path: {phase_launches}"
    assert resident_flooding_decode.launches == 0
    for key in keys:
        assert torch.equal(out[key], stream[key]), f"streaming flagship: {key} differs"
    iters = out["iterations"]
    executed = int(iters.max())
    print(f"flagship flooding decode: {resident_launches} resident kernel "
          f"launch(es), output equal to the plain version (tolerance 0); the "
          f"streaming path ({phase_launches}) gives the same output; "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, average "
          f"iterations {float(iters.float().mean()):.2f}, {executed} executed")

    q, bits0, layout, rule = tiles
    nbt, VG, Z, Bt = q.shape
    E, s = layout.E, q.element_size()
    edges, lanes = E * Z * Bt * nbt, VG * Z * Bt * nbt
    scale_op = int(rule.scale != 1.0)
    tag = f"flagship B={FLAGSHIP_BATCH} Minsumbf16"
    init = fused_var(None, q, layout, rule)
    hold(worst, "fused_var", tag, init, fused_var_reference(None, q, layout, rule))
    v2c0 = init[0]
    c2v = fused_check(v2c0, layout, rule)
    hold(worst, "fused_check", tag, [c2v], [fused_check_reference(v2c0, layout, rule)])
    v2c, bits = fused_var(c2v, q, layout, rule)
    hold(worst, "fused_var", tag, [v2c, bits], fused_var_reference(c2v, q, layout, rule))
    # frame 0 of every other tile set to the all-zero codeword, which
    # satisfies every check: the syndrome must pass those frames and no other
    mixed = bits.clone()
    mixed[::2, :, :, 0] = 0
    for b in (bits0, bits, mixed):
        flags = fused_syndrome_bits(b, layout)
        hold(worst, "fused_syndrome_bits", tag, [flags],
             [fused_syndrome_bits_reference(b, layout)])
    passed = flags == 0
    assert passed[::2, 0].all() and int(passed.sum()) == nbt - nbt // 2, \
        "syndrome of the mixed bits"
    torch.cuda.synchronize()
    print(f"flooding kernels vs plain: {tag}: fused_var (init and update), "
          f"fused_check and fused_syndrome_bits (raw, posterior and mixed "
          f"bits: {int(passed.sum())} of {passed.numel()} frames pass) equal "
          "(tolerance 0)")
    decode_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    resident_ms = cuda_ms(lambda: resident_flooding_decode(*tiles, FLAGSHIP_ITERS), 5)
    stream_ms = cuda_ms(lambda: streaming_flooding_decode(*tiles, FLAGSHIP_ITERS), 3)
    plain_ms = cuda_ms(lambda: resident_flooding_decode_reference(*tiles, FLAGSHIP_ITERS), 3)
    timed = {
        "fused_check": (
            cuda_ms(lambda: fused_check(v2c0, layout, rule), 10),
            cuda_ms(lambda: fused_check_reference(v2c0, layout, rule), 3),
            bound(2 * edges * s, edges * (CHECK_OPS + scale_op)),
        ),
        "fused_var": (
            cuda_ms(lambda: fused_var(c2v, q, layout, rule), 10),
            cuda_ms(lambda: fused_var_reference(c2v, q, layout, rule), 3),
            bound(2 * edges * s + lanes * (s + 1),
                  edges * VAR_EDGE_OPS + lanes * VAR_LANE_OPS),
        ),
        "fused_syndrome_bits": (
            cuda_ms(lambda: fused_syndrome_bits(bits, layout), 10),
            cuda_ms(lambda: fused_syndrome_bits_reference(bits, layout), 3),
            bound(lanes + nbt * Bt * 4, edges * SYN_OPS),
        ),
    }
    init_ms = cuda_ms(lambda: fused_var(None, q, layout, rule), 10)
    tile_its = int(tile_iterations(iters, Bt).sum())
    edge_tile, lane_tile = E * Z * Bt, VG * Z * Bt
    ops = tile_its * (edge_tile * (CHECK_OPS + scale_op + VAR_EDGE_OPS + SYN_OPS)
                      + lane_tile * VAR_LANE_OPS)
    res_bound, res_by = bound(lanes * (s + 1 + 1) + nbt * Bt * 8, ops)
    # per tile-iteration: v2c and c2v read and written, q read, bits
    # written, and the bits read once per edge by the syndrome
    state_ms = 1e3 * tile_its * (4 * edge_tile * s + lane_tile * (s + 1) + edge_tile) \
        / HBM_BYTES_PER_S
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    print(f"[{card}] flagship flooding Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, {decode_ms / executed:.3f} ms/iter, "
          "median of 5")
    print(f"[{card}] resident_flooding_decode kernel: {resident_ms:.3f} ms "
          f"({resident_ms / executed:.3f} ms/iter); plain version {plain_ms:.3f} ms "
          f"({plain_ms / executed:.3f} ms/iter); bound {res_bound:.4f} ms by "
          f"{res_by} (inputs and outputs once; {100 * res_bound / resident_ms:.1f}% "
          f"of bound); state-traffic floor {state_ms:.3f} ms ({tile_its} "
          "tile-iterations)")
    print(f"[{card}] streaming flooding path: {stream_ms:.3f} ms "
          f"({stream_ms / executed:.3f} ms/iter, median of 3); fused_var init "
          f"{init_ms:.3f} ms")
    for name, (ms, pms, (bms, by)) in timed.items():
        print(f"[{card}] {name}: {ms:.3f} ms per iteration, plain {pms:.3f} ms, "
              f"bound {bms:.4f} ms by {by} ({100 * bms / ms:.1f}% of bound)")
    flooding_at_working_point(card, dec)
    entries = [{
        "name": "resident_flooding_decode",
        "route": "cuda",
        "source": "ldpc_toolbox_torch/csrc/flooding.cu",
        "replaces": "ldpc_toolbox_tpu/ops/resident_flooding_dual.py:133 and "
                    "ldpc_toolbox_tpu/ops/resident_flooding.py:144",
        "launches": resident_launches,
        "ms": resident_ms,
        "plain_ms": plain_ms,
        "bound_ms": res_bound,
        "bound_by": res_by,
        "library_ms": None,
    }]
    replaces = {
        "fused_check": "ldpc_toolbox_tpu/ops/fused_bp2.py:774",
        "fused_var": "ldpc_toolbox_tpu/ops/fused_bp2.py:910",
        "fused_syndrome_bits": "ldpc_toolbox_tpu/ops/fused_bp2.py:1098",
    }
    for name, (ms, pms, (bms, by)) in timed.items():
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "ldpc_toolbox_torch/csrc/flooding.cu",
            "replaces": replaces[name],
            "launches": phase_launches[name],
            "ms": ms,
            "plain_ms": pms,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
        })
    return entries


def flooding_at_working_point(card, dec):
    """Resident against streaming on the flagship at 2.5 dB, where frames
    converge at different iterations and freeze: equal outputs, equal to
    the plain version, and both paths' times."""
    llrs = channel_llrs(dec.lifted.n, FLAGSHIP_BATCH, sigma_at(R1_2_RATE, 2.5), seed=0)
    keys = ("codeword", "iterations", "success")
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)

    def streaming():
        return lifted_flooding_decode(
            dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS, resident=False
        )

    stream = streaming()
    ref = tiles_to_output(
        dec.lifted,
        *resident_flooding_decode_reference(
            *flooding_tiles(dec.lifted, dec.arithmetic, llrs), FLAGSHIP_ITERS
        ),
        FLAGSHIP_BATCH,
    )
    for key in keys:
        assert torch.equal(out[key], stream[key]), f"2.5 dB streaming: {key} differs"
        assert torch.equal(out[key], ref[key]), f"2.5 dB plain: {key} differs"
    iters = out["iterations"]
    converged = int(out["success"].sum())
    assert 0 < converged, "no frame converged at 2.5 dB"
    resident_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    stream_ms = cuda_ms(streaming, 5)
    print(f"[{card}] flagship flooding at 2.5 dB: {converged}/{FLAGSHIP_BATCH} "
          f"converged, average iterations {float(iters.float().mean()):.2f}, "
          f"{int(iters.max())} at most; resident (Decoder.decode_batch) and "
          f"streaming equal each other and the plain version; resident "
          f"{resident_ms:.3f} ms, streaming {stream_ms:.3f} ms, median of 5")


def ber_sweep(card, lifted, name, points, iters, high_fer):
    """A two-point BER sweep through BerTestBuilder on the card."""
    test = BerTestBuilder(
        h=Code.R1_2.h(), lifted_graph=lifted, decoder_implementation=name,
        max_frame_errors=2000, max_run_time=6.0, max_iterations=iters,
        ebn0s_db=points, batch_size=FLAGSHIP_BATCH, seed=0, device="cuda",
    ).build()
    low, high = test.run()
    for s in (low, high):
        print(f"[{card}] ber {name} {s.ebn0_db} dB: {s.num_frames} frames, FER "
              f"{s.ldpc.fer:.3e}, BER {s.ldpc.ber:.3e}, average iterations "
              f"{s.average_iterations:.2f}, {s.throughput_mbps:.1f} Mbit/s")
        assert s.num_frames >= FLAGSHIP_BATCH
    assert low.ldpc.fer >= 0.9, f"{name}: FER at {low.ebn0_db} dB is {low.ldpc.fer}"
    assert high.ldpc.fer <= high_fer, f"{name}: FER at {high.ebn0_db} dB is {high.ldpc.fer}"


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
    t_start = time.perf_counter()

    build()
    graphs = test_graphs()
    layered_worst = layered_checks(graphs)
    flooding_worst = flooding_checks(graphs)

    code = Code.R1_2
    llrs = channel_llrs(code.n, FLAGSHIP_BATCH, sigma_at(R1_2_RATE, FLAGSHIP_EBN0), seed=0)
    lifted, kernels = flagship_layered(card, llrs)
    kernels[0]["max_abs_err"] = layered_worst
    for entry in flagship_flooding(card, llrs, flooding_worst):
        entry["max_abs_err"] = flooding_worst[entry["name"]]
        kernels.append(entry)
    ber_sweep(card, lifted, "HLMinsumbf16", [0.5, 2.0], FLAGSHIP_ITERS, 0.01)
    ber_sweep(card, lifted, "Minsumbf16", [0.5, 2.5], FLAGSHIP_ITERS, 0.01)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
