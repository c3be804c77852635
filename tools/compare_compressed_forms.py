"""Time forms of the compressed check-state kernels in turns on one GPU.

    python3 tools/compare_compressed_forms.py [--form NAME=DIR[:THREADS] ...]
        [--pr3 DIR] [--reps 5]

A form is a directory holding a ``compressed.cu`` and the ``layered.cuh``
it includes, built here with the package's nvcc flags; "repo" is the
package's own ``csrc/``. ``--form`` forms share the package's C interface
and run at the package's block size, or at THREADS a block where given;
``--pr3`` names a form whose flooding entry point has no degree argument
(the PR 3 source, ``git show 78254fe:ldpc_toolbox_torch/csrc/compressed.cu``
and its ``layered.cuh``), run at its 512 threads a block. nvcc's report
of each form goes to ``chiprun_out/forms/NAME.log``.

On the flagship decode (DVB-S2 R1_2, B = 1024, 1.0 dB, at most 30
iterations, f32 tiles of ``HLMinsumf32`` and ``Minsumf32``) it holds
every form's bits, iterations and flags equal to the package kernel's,
then times all forms and the f32 message kernel on the same tiles in
turns (the order reversed every round; CUDA events, median of
``--reps``). Prints the card's name and power limit, a line a schedule
and one JSON line with every time in milliseconds.
"""

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import (  # noqa: E402
    FLAGSHIP_BATCH,
    FLAGSHIP_EBN0,
    FLAGSHIP_ITERS,
    R1_2_RATE,
    channel_llrs,
    event_ms,
    sigma_at,
)
from ldpc_toolbox_torch.codes.dvbs2 import Code  # noqa: E402
from ldpc_toolbox_torch.decoder.factory import make_arithmetic  # noqa: E402
from ldpc_toolbox_torch.decoder.lifted import lifted_graph_for  # noqa: E402
from ldpc_toolbox_torch.decoder.lifted_flooding import flooding_tiles  # noqa: E402
from ldpc_toolbox_torch.decoder.lifted_layered import tile_inputs  # noqa: E402
from ldpc_toolbox_torch.ops import _build, resident_compressed  # noqa: E402
from ldpc_toolbox_torch.ops.fused_bp2 import _MSG_DTYPES  # noqa: E402
from ldpc_toolbox_torch.ops.resident_flooding import resident_flooding_decode  # noqa: E402
from ldpc_toolbox_torch.ops.resident_layered import (  # noqa: E402
    layered_launch,
    resident_layered_decode,
)

OUT = pathlib.Path(__file__).resolve().parent.parent / "chiprun_out" / "forms"


def build(name, src_dir):
    """Builds ``src_dir/compressed.cu`` into ``chiprun_out/forms/``."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
         str(pathlib.Path(src_dir) / "compressed.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return resident_compressed.bind(ctypes.CDLL(str(so)))


def with_lib(lib, threads, fn, *args):
    """fn(*args) with the package's wrappers launching ``lib`` at
    ``threads`` threads a block."""
    saved = resident_compressed._lib, resident_compressed.COMPRESSED_THREADS
    resident_compressed._lib = lambda: lib
    resident_compressed.COMPRESSED_THREADS = threads
    try:
        return fn(*args)
    finally:
        resident_compressed._lib, resident_compressed.COMPRESSED_THREADS = saved


def pr3_flooding(lib, q_t, bits0_t, layout, rule, max_iterations):
    """The PR 3 wrapper of the compressed flooding kernel (no degree
    argument, 512 threads)."""
    lib.ldpc_compressed_flooding_decode.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    )
    nbt, VG, Z, Bt = q_t.shape
    s = torch.empty((nbt, VG, Z, Bt), dtype=torch.float32, device=q_t.device)
    tables, dims, _, stream = layered_launch(s, layout, rule, max_iterations,
                                             with_park=False)
    ssign, min1, min2 = resident_compressed._state(nbt, layout, Z, Bt,
                                                   rule.storage_dtype, q_t.device)
    argm = torch.zeros((nbt, layout.CG, Z, Bt), dtype=torch.int8, device=q_t.device)
    bits = bits0_t.clone()
    iters = torch.empty((nbt, Bt), dtype=torch.int32, device=q_t.device)
    conv = torch.empty_like(iters)
    err = lib.ldpc_compressed_flooding_decode(
        s.data_ptr(), q_t.data_ptr(), ssign.data_ptr(), min1.data_ptr(),
        min2.data_ptr(), argm.data_ptr(), bits.data_ptr(), iters.data_ptr(),
        conv.data_ptr(), tables, *dims[:6], int(max_iterations), 512, rule.big,
        rule.scale, _MSG_DTYPES[rule.storage_dtype], stream,
    )
    if err:
        raise RuntimeError(f"PR 3 flooding launch failed: {err}")
    return bits, iters, conv


def turns(fns, reps):
    """Medians of ``reps`` timings of each fn in turns, after a warm-up."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(reps):
        for name in order if r % 2 == 0 else order[::-1]:
            times[name].append(event_ms(fns[name]))
    return {name: statistics.median(ts) for name, ts in times.items()}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--form", action="append", default=[], metavar="NAME=DIR[:THREADS]")
    p.add_argument("--pr3", metavar="DIR")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    sources = {"repo": _build.CSRC}
    block = {"repo": resident_compressed.COMPRESSED_THREADS}
    for form in args.form:
        name, spec = form.split("=", 1)
        sources[name], _, n = spec.partition(":")
        block[name] = int(n) if n else resident_compressed.COMPRESSED_THREADS
    if args.pr3:
        sources["pr3"] = args.pr3
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    for name in built:
        print(f"{name}: nvcc's report in chiprun_out/forms/{name}.log")

    lg = lifted_graph_for(Code.R1_2)
    llrs = channel_llrs(lg.n, FLAGSHIP_BATCH, sigma_at(R1_2_RATE, FLAGSHIP_EBN0), seed=0)
    result = {"card": card}
    for schedule, name, tiles, kernel, message in (
        ("layered", "HLMinsumf32", tile_inputs, "compressed_layered_decode",
         resident_layered_decode),
        ("flooding", "Minsumf32", flooding_tiles, "compressed_flooding_decode",
         resident_flooding_decode),
    ):
        t = tiles(lg, make_arithmetic(name)[1], llrs)
        wrapper = getattr(resident_compressed, kernel)
        fns = {}
        for form, lib in built.items():
            if form == "pr3" and schedule == "flooding":
                fns[form] = lambda lib=lib: pr3_flooding(lib, *t, FLAGSHIP_ITERS)
            else:
                n = block.get(form, 512)
                fns[form] = lambda lib=lib, n=n: with_lib(lib, n, wrapper, *t,
                                                          FLAGSHIP_ITERS)
        fns["message"] = lambda: message(*t, FLAGSHIP_ITERS)
        ref = fns["repo"]()
        for form, fn in fns.items():
            for a, b in zip(fn(), ref):
                assert torch.equal(a, b), f"{schedule}: form {form} differs from repo"
        ms = turns(fns, args.reps)
        result[schedule] = ms
        print(f"[{card}] {schedule} {name} B={FLAGSHIP_BATCH}: all forms equal; "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f" (in turns, median of {args.reps})")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
