"""Time forms of kernel sources in turns on one GPU.

    python3 tools/compare_forms.py --source SOURCE [--source SOURCE ...]
        [--form NAME=DIR[:THREADS[:VAR]] ...] [--base DIR] [--reps 5] [--batch 1024 ...]
        [--buckets] [--sass-only] [--counts REGEX]

SOURCE is one of compressed, flooding, resident_layered (min-sum),
resident_layered_i8, flooding_i8 (the i8 instances), resident_layered_f32,
resident_layered_f64, flooding_f32, flooding_f64 (the float-rule instances),
fused_layered_i8, fused_layered_f32, fused_layered_f64 (the streaming
sweep's i8 and float instances), streaming (the min-sum streaming
kernels: the layered sweep of ``csrc/fused_layered.cu`` and the check and
variable phases of ``csrc/flooding.cu``), or probes (the copy stream of
``csrc/probes.cu``: P1, P4's copy and P2 roll). A form is a directory holding a
version of the kernel sources (``csrc/<source>.cu`` and the headers it
includes), built here with the package's nvcc flags; "repo" is the package's
own ``csrc/``, built into the package's ``build/`` as its wrappers build it.
``--form`` forms share the package's C interface and run at the package's
block sizes, or at THREADS a block where given (every lane kernel of the
form, the float rules' layered frame pairs, the f64 sweep's and the i8
instances among them: a form of before the f64 float rules' (lane, frame) units runs its
f64 flooding kernels at 256, and so does a form of before the i8 rules'
blocks of 512 and 384 run its i8 kernels, or one of before the f64 layered
frame pairs of 384 its f64 layered kernels and sweep; a form of before the
i8 rules' own sweep and check phase (``csrc/i8_streaming.cuh``) runs
its i8 sweep at 256 (``:256`` with ``--source fused_layered_i8``) and its
check phase at its flooding block, 512 (``:512`` with ``--source
flooding_i8``), since THREADS sets every block; VAR, where given, sets
the block of the f32 float rules' variable phase apart, whose units are its
own). ``--base`` names a directory holding the sources
of commit c5040f6 (``git show c5040f6:ldpc_toolbox_torch/csrc/<file>`` for
compressed, flooding and resident_layered and ``layered.cuh``), whose
message kernels give a thread one (lane, frame); they run as they ran there:
the compressed kernels at 256 threads, the message kernels at 512 threads a
block, the resident flooding kernel through its own C interface (two message
arrays, the eleven flooding tables). Each form is built into the package's
git-ignored ``build/forms/``, nvcc's report beside it as
``<source>-NAME.log``; every build of the run starts at once.

Each source's resident kernels run the flagship decode (DVB-S2 R1_2, B =
1024, 1.0 dB, at most 30 iterations) on the tiles of their names: the bf16
and the f32 min-sum names of their schedule, ``HLMinstarapproxi8`` or
``Minstarapproxi8`` for the i8 sources, ``HLPhif32``, ``HLPhif64``,
``Phif32`` or ``Phif64`` for the float ones. On each tile set it holds every
form's bits, iterations and flags equal to the package kernel's, then times
all forms, and for a min-sum source the package's kernel of the other check
state (the compressed kernel for a message source, the message kernel for
the compressed one), on the same tiles in turns (the order reversed every
round; CUDA events, median of ``--reps``). A form whose flooding source
predates the i8 and float phase instances times its resident kernel all the
same. The i8 and float flooding sources then time their check and variable
phases (TPU #7 and #8) too, on the flagship's planes of their name after one
iteration (the check phase's v2c and the variable phase's c2v), each form's
outputs equal to the package's, bit for bit, before the timing.

``streaming`` times one sweep (``fused_layered_iteration``) on the
flagship's ``HLMinsumbf16`` tiles, in place (each form decodes on from the
same planes), and ``fused_check`` and ``fused_var`` on its ``Minsumbf16``
and ``Minsumf32`` tiles; a form without ``fused_layered.cu`` holds the
sources of before the lane form (a thread per (lane, frame)): its sweep is
built from its ``resident_layered.cu`` and runs at 512 threads a block, and
its check phase takes no degree bucket. Every form's outputs equal the
package's, bit for bit, before the timing.

The i8 and float sweep sources time one sweep on their name's tiles
(``HLMinstarapproxi8``, ``HLPhif32``, ``HLPhif64``) as ``streaming`` does.
For every source and form it also compares each kernel's SASS (``cuobjdump
-sass``, addresses and encodings dropped) with the package's build and names
the kernels whose code differs: a kernel of the same code runs the same.

``probes`` holds P1 (``copybw.stream_slabs``) at the tool's six slab
shapes and P4's copy (``v2.plane_copy``) at Bt = 128, 256 and 512 (B =
512) of every form equal to the plain version, bit for bit, then times
every form and the library call (torch's ``src + 1``, ``Tensor.copy_``) in
turns, each a chain of launches behind a busy stream, the host path out of
the window (``probes._kernels.chain_ms`` and ``turns``: the median over
``--reps`` rounds of each chain's median); then P2 roll
(``vpu_peak.alu_chain(x, "roll")``) at the tool's 132 planes, every form
equal to the plain version at 301 rounds and timed in turns at the
tool's 32768 (no library call); and prints nvcc's registers, stack and
spills of each form's stream and roll kernels.

``--batch`` times every source at other batch sizes too, one run after
the other on the same builds (528 frames: one tile an SM of the card's 132,
against the flagship's two). ``--sass-only`` stops after the builds and
the SASS comparison: nothing is timed. ``--counts REGEX`` prints, for each
source and form, the static SASS instructions of every kernel whose name
matches REGEX by the pipe they issue to (ALU, FMA, memory, control, moves,
uniform) and its most frequent ALU opcodes.

Prints the card's name and power limit, a line a tile set with each form's
time and, from nvcc's report of its build, the registers, stack-frame and
spill-store bytes of the flagship instance it ran (bucket 8, the name's
rule), and one JSON line with every time in milliseconds; ``--buckets``
prints that report for every degree bucket's instance of the name's rule
too.
"""

import argparse
import ctypes
import functools
import json
import pathlib
import re
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
    sass,
    seeded_cuda,
    sigma_at,
)
from ldpc_toolbox_torch.codes.dvbs2 import Code  # noqa: E402
from ldpc_toolbox_torch.decoder.factory import make_arithmetic  # noqa: E402
from ldpc_toolbox_torch.decoder.lifted import lifted_graph_for  # noqa: E402
from ldpc_toolbox_torch.decoder.lifted_flooding import flooding_tiles  # noqa: E402
from ldpc_toolbox_torch.decoder.lifted_layered import tile_inputs  # noqa: E402
from ldpc_toolbox_torch.ops import (  # noqa: E402
    _build,
    fused_bp2,
    fused_layered,
    resident_compressed,
    resident_flooding,
    resident_layered,
)
from ldpc_toolbox_torch.probes import _kernels as probe_kernels  # noqa: E402
from ldpc_toolbox_torch.probes import copybw, v2, vpu_peak  # noqa: E402

OUT = _build.BUILD_DIR / "forms"
#: the frames of the decodes being timed
BATCH = FLAGSHIP_BATCH
#: per source: (schedule, the wrapper's module, the name there of its
#: library getter, the wrapper, the other check state's kernel or None,
#: the library binder)
PLAN = {
    "compressed": [
        ("layered", resident_compressed, "_lib", "compressed_layered_decode",
         resident_layered.resident_layered_decode, resident_compressed.bind),
        ("flooding", resident_compressed, "_lib", "compressed_flooding_decode",
         resident_flooding.resident_flooding_decode, resident_compressed.bind),
    ],
    "resident_layered": [
        ("layered", resident_layered, "_lib", "resident_layered_decode",
         resident_compressed.compressed_layered_decode, resident_layered.bind),
    ],
    "flooding": [
        ("flooding", resident_flooding, "flooding_lib", "resident_flooding_decode",
         resident_compressed.compressed_flooding_decode, None),
    ],
    "resident_layered_i8": [
        ("layered", resident_layered, "_lib_i8", "resident_layered_decode_i8", None,
         resident_layered.bind_i8),
    ],
    "flooding_i8": [
        ("flooding", resident_flooding, "flooding_i8_lib", "resident_flooding_decode_i8", None,
         fused_bp2.bind_flooding_i8),
    ],
    **{f"resident_layered_{p}": [
        ("layered", resident_layered, "_lib_float", "resident_layered_decode_float", None,
         resident_layered.bind_float)] for p in ("f32", "f64")},
    **{f"flooding_{p}": [
        ("flooding", resident_flooding, "flooding_float_lib", "resident_flooding_decode_float",
         None, fused_bp2.bind_flooding_float)] for p in ("f32", "f64")},
}
NAMES = {"layered": ("HLMinsumbf16", "HLMinsumf32"), "flooding": ("Minsumbf16", "Minsumf32")}
#: the names of the sources that do not run the min-sum names
SOURCE_NAMES = {
    "resident_layered_i8": ("HLMinstarapproxi8",), "flooding_i8": ("Minstarapproxi8",),
    "resident_layered_f32": ("HLPhif32",), "resident_layered_f64": ("HLPhif64",),
    "flooding_f32": ("Phif32",), "flooding_f64": ("Phif64",),
    "fused_layered_i8": ("HLMinstarapproxi8",), "fused_layered_f32": ("HLPhif32",),
    "fused_layered_f64": ("HLPhif64",),
}
#: the streaming sweep's i8 and float sources: (its wrapper, the name of its
#: library getter in ``fused_layered``, its binder)
SWEEPS = {
    "fused_layered_i8": ("fused_layered_iteration_i8", "_lib_i8", fused_layered.bind_i8),
    **{f"fused_layered_{p}": ("fused_layered_iteration_float", "_lib_float",
                              fused_layered.bind_float) for p in ("f32", "f64")},
}
#: the rounds at which ``probes`` holds P2 roll's forms to the plain version
ROLL_CHECK_ROUNDS = 301
#: block sizes of the c5040f6 forms, by source
BASE_THREADS = {"compressed": 256, "resident_layered": 512, "flooding": 512}
#: the block size of the streaming sweep of before the lane form
PER_FRAME_SWEEP_THREADS = 512


def build(source, name, src_dir):
    """Builds ``src_dir/<source>.cu`` into ``OUT``."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{source}-{name}.so"
    report = _build.compile_source(pathlib.Path(src_dir) / f"{source}.cu", so)
    so.with_suffix(".log").write_text(report)
    return ctypes.CDLL(str(so))


def with_lib(module, getter, lib, threads, fn, *args):
    """fn(*args) with ``module``'s wrappers launching ``lib``, at
    ``threads`` threads a block unless it is None (the lane kernels, the
    phases, the f64 flooding kernels and the i8 instances; ``threads`` a
    pair: the f32 float rules' variable phase at the second)."""
    patches = [(module, getter, lambda *_: lib)]
    if threads is not None:
        threads, var = threads
        patches += [(m, name, threads) for m, name in (
            (module, "LANE_THREADS"), (module, "I8_LAYERED_THREADS"),
            (module, "F64_LAYERED_THREADS"),
            (fused_bp2, "PHASE_THREADS"), (fused_bp2, "F64_UNIT_THREADS"),
            (fused_bp2, "F32_UNIT_THREADS"), (fused_bp2, "I8_FLOODING_THREADS"))
            if hasattr(m, name)]
        patches.append((fused_bp2, "F32_VAR_THREADS", var))
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, value in patches:
        setattr(m, name, value)
    try:
        return fn(*args)
    finally:
        for m, name, value in reversed(saved):
            setattr(m, name, value)


def base_flooding(lib, q_t, bits0_t, layout, rule, max_iterations):
    """The c5040f6 resident flooding kernel through its own C interface
    (v2c and c2v arrays, the eleven flooding tables, 512 threads a
    block)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_resident_flooding_decode.argtypes = [p] * 8 + [i] * 6 + [i, i, f, f, i, p]
    tables, dims, stream = fused_bp2.launch_args(q_t, layout, rule)
    nbt, VG, Z, Bt = q_t.shape
    v2c = torch.empty((nbt, layout.E, Z, Bt), dtype=q_t.dtype, device=q_t.device)
    c2v = torch.empty_like(v2c)
    post = torch.empty_like(bits0_t)
    bits = bits0_t.clone()
    iters = torch.empty((nbt, Bt), dtype=torch.int32, device=q_t.device)
    conv = torch.empty_like(iters)
    err = lib.ldpc_resident_flooding_decode(
        v2c.data_ptr(), c2v.data_ptr(), q_t.data_ptr(), post.data_ptr(),
        bits.data_ptr(), iters.data_ptr(), conv.data_ptr(), tables, *dims,
        int(max_iterations), 512, rule.big, rule.scale,
        fused_bp2._MSG_DTYPES[rule.storage_dtype], stream,
    )
    if err:
        raise RuntimeError(f"base flooding launch failed: {err}")
    return bits, iters, conv


#: the kernel each wrapper launches
KERNEL_OF = {
    "resident_layered_decode": "resident_layered_kernel",
    "resident_flooding_decode": "resident_flooding_kernel",
    "compressed_layered_decode": "compressed_layered_kernel",
    "compressed_flooding_decode": "compressed_flooding_kernel",
    "fused_layered_iteration": "fused_layered_kernel",
    "fused_check": "fused_check_kernel",
    "fused_var": "fused_var_kernel",
}
#: nvcc's reports, by (source, form): the package's build of a source is
#: form "repo"
LOGS = {}
_CTYPE = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16", torch.float64: "double"}


#: the i8 rules' own sweep and check phase kernels (csrc/i8_streaming.cuh),
#: by the template kernel they replace there
I8_KERNELS = {"fused_layered_kernel": "i8_sweep_kernel", "fused_check_kernel": "i8_check_kernel"}


def instance(wrapper, rule, own=True, bucket=8):
    """The demangled name (``ldpc::`` and spaces dropped) of the instance
    of degree bucket ``bucket`` (the flagship's: 8) that ``wrapper``
    launches under ``rule`` (``own`` False: the template kernel's, which a
    form of before the i8 rules' own sweep and check phase, or of before
    the min-sum rule's ring kernel, launches)."""
    kernel = next(k for w, k in KERNEL_OF.items() if wrapper.startswith(w))
    if fused_bp2.is_i8(rule) and own and kernel in I8_KERNELS:
        return f"{I8_KERNELS[kernel]}<{bucket},{rule.kind}>"
    if fused_bp2.is_i8(rule):
        tag = f"I8Rule<{rule.kind}>"
    elif fused_bp2.is_float_rule(rule):
        tag = f"FloatRule<{_CTYPE[rule.storage_dtype]},{rule.kind}>"
    else:
        ctype = _CTYPE[rule.storage_dtype]
        if own and kernel == "resident_flooding_kernel":
            return f"flooding_ring_kernel<{bucket},{ctype}>"
        tag = ctype if kernel.startswith("compressed") else f"MinSumRule<{ctype}>"
    return f"{kernel}<{tag}>" if kernel == "fused_var_kernel" else f"{kernel}<{bucket},{tag}>"


@functools.cache
def ptxas_report(log):
    """{kernel (demangled, ``ldpc::`` and spaces dropped): (registers,
    stack-frame bytes, spill-store bytes)} of an nvcc ``-Xptxas -v``
    report."""
    regs, frames, fn = {}, {}, None
    for line in pathlib.Path(log).read_text().splitlines():
        if m := re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line):
            fn = m.group(1)
        elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)):
            frames[fn] = (int(m.group(1)), int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            regs[fn] = int(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(regs), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    short = (re.sub(r"\(anonymous namespace\)::|ldpc::", "", n).split("(")[0] for n in names)
    return {re.sub(r"\s", "", n).removeprefix("void"): (r, *frames.get(k, (0, 0)))
            for n, (k, r) in zip(short, regs.items())}


def report_text(found):
    """nvcc's report of one kernel as printed: registers, stack, spills."""
    regs, stack, spill = found
    return f"{regs} regs, {stack} B stack, {spill} B spill"


def make_rule(name):
    """The rule policy of a decoder name."""
    return fused_bp2.rule_for(make_arithmetic(name)[1])


def registers(source, forms, wrapper, rule, bucket=8):
    """{form: "R regs, S B stack, P B spill"} of the instance (of degree
    bucket ``bucket``) each form of ``source`` ran, from nvcc's report of
    its build (empty where no report is kept)."""
    out = {}
    for form in forms:
        log = LOGS.get((source, form))
        report = ptxas_report(str(log)) if log else {}
        found = (report.get(instance(wrapper, rule, bucket=bucket))
                 or report.get(instance(wrapper, rule, False, bucket)))
        if found:
            out[form] = report_text(found)
    return out


def print_buckets(source, forms):
    """Prints, for each form of ``source``, nvcc's report of every degree
    bucket's instance of each kernel under the rule of the source's first
    name (the float instances above bucket 16 keep their arrays in local
    memory)."""
    tag = instance("resident_layered_decode", make_rule(
        SOURCE_NAMES.get(source, NAMES["layered"])[0])).split(",", 1)[1][:-1]
    for form in forms:
        log = LOGS.get((source, form))
        if log is None:
            continue
        found = sorted(((k, v) for k, v in ptxas_report(str(log)).items() if tag in k),
                       key=lambda kv: (kv[0].split("<")[0], len(kv[0]), kv[0]))
        print(f"{source} {form} ({tag}): " + "; ".join(
            re.sub(r"<(\d+,)?.*", lambda m: f" {m[1][:-1]}" if m[1] else "", k)
            + f" {report_text(v)}" for k, v in found))


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
    global BATCH
    p = argparse.ArgumentParser()
    p.add_argument("--source", action="append", required=True,
                   choices=sorted(PLAN) + sorted(SWEEPS) + ["streaming", "probes"])
    p.add_argument("--form", action="append", default=[], metavar="NAME=DIR[:THREADS[:VAR]]")
    p.add_argument("--base", metavar="DIR")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--batch", type=int, action="append",
                   help=f"frames a decode (repeatable; default {FLAGSHIP_BATCH})")
    p.add_argument("--buckets", action="store_true",
                   help="print nvcc's report of every degree bucket's instance of the "
                        "sources' flagship rules")
    p.add_argument("--sass-only", action="store_true",
                   help="build and compare the SASS, time nothing")
    p.add_argument("--counts", metavar="REGEX",
                   help="print the SASS instructions of each form's kernels whose name "
                        "matches REGEX, by the pipe they issue to")
    p.add_argument("--cell", action="append", default=[], metavar="WORKLOAD",
                   help="time the resident decodes of the sources of the cell's schedule at "
                        "a benchmark cell's shape too (BENCHMARK.json), on its first step's "
                        "LLRs (repeatable)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    forms, block = {}, {}
    for form in args.form:
        name, spec = form.split("=", 1)
        forms[name], _, n = spec.partition(":")
        if n:
            n, _, var = n.partition(":")
            block[name] = (int(n), int(var or n))
    if args.base:
        forms["base"] = args.base
    sources = [s for s in args.source if s != "streaming"]
    # the package's sources these runs load (the other check state's kernel
    # of a min-sum source too) and every form, all built at once
    package = set(sources)
    if package & {"compressed", "resident_layered", "flooding"}:
        package |= {"compressed", "resident_layered", "flooding"}
    jobs = [(source, form, d) for source in sources for form, d in forms.items()]
    if "streaming" in args.source:
        package |= {"fused_layered", "flooding"}
        for form, d in forms.items():
            lane = (pathlib.Path(d) / "fused_layered.cu").exists()
            jobs.append(("fused_layered" if lane else "resident_layered",
                         f"{form}-sweep", d))
            jobs.append(("flooding", f"{form}-phases", d))
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        pkg = pool.submit(_build.build_all, sorted(package))
        built = list(pool.map(lambda j: build(*j), jobs))
        pkg.result()
    libs = {source: {"repo": ctypes.CDLL(str(_build.library_path(source)))}
            for source in sources}
    for (source, form, _), lib in zip(jobs, built):
        if source in libs and form in forms:
            libs[source][form] = lib
    print(f"nvcc's reports in {OUT}/<source>-<form>.log")
    for source in sources:
        LOGS[(source, "repo")] = _build.library_path(source).with_suffix(".log")
    for source, form, _ in jobs:
        LOGS[(source, form)] = OUT / f"{source}-{form}.log"
    for source, form, _ in jobs:
        # the streaming forms' sweep and phase builds too, where the form has
        # the lane form's sources
        if (source in libs and form in forms) or (
                source in ("fused_layered", "flooding") and form not in forms):
            n, differ = sass_differs(_build.library_path(source), OUT / f"{source}-{form}.so")
            print(f"{source} {form}: {n} kernels, SASS differing from repo: "
                  + (", ".join(differ) or "none"))
    if args.counts:
        for source, form, _ in [(s, "repo", None) for s in sources] + jobs:
            so = (_build.library_path(source) if form == "repo"
                  else OUT / f"{source}-{form}.so")
            for kernel, code in sorted(sass(so).items()):
                if re.search(args.counts, re.sub(r"\s", "", kernel)):
                    print(f"{source} {form} {kernel}: {sass_counts(code)}")
    if args.buckets:
        for source in sources:
            if source != "probes":
                print_buckets(source, ["repo", *forms])
    if args.sass_only:
        return

    result = {"card": card}
    if "probes" in sources:
        sources.remove("probes")
        run_probes(libs["probes"], args.reps, card, result)
    lg = lifted_graph_for(Code.R1_2) if sources or "streaming" in args.source else None
    for batch in (args.batch or [FLAGSHIP_BATCH]) if lg else ():
        BATCH = batch
        llrs = channel_llrs(lg.n, batch, sigma_at(R1_2_RATE, FLAGSHIP_EBN0), seed=0)
        for source in sources:
            run_source(source, libs[source], block, lg, llrs, args.reps, card, result)
    for workload in args.cell:
        run_cell(workload, sources, libs, block, args.reps, card, result)
    if "streaming" in args.source:
        streaming = {"repo": (True, fused_layered._lib(), fused_bp2.flooding_lib())}
        for form, d in forms.items():
            lane = (pathlib.Path(d) / "fused_layered.cu").exists()
            sweep, phases = (lib for (_, name, _), lib in zip(jobs, built)
                             if name in (f"{form}-sweep", f"{form}-phases"))
            streaming[form] = (lane, fused_layered.bind(sweep), phases)
        run_streaming(streaming, lg, llrs, args.reps, card, result)
    print(json.dumps(result))


#: SASS opcodes by the pipe they issue to on Hopper: the FMA pipe (IMAD and
#: its kin issue there, as the f32 arithmetic does), memory, control, moves;
#: the uniform datapath's (U...) apart; every other arithmetic or logic
#: opcode is the integer (ALU) pipe's
SASS_PIPES = {
    "fma": ("IMAD", "FFMA", "FMUL", "FADD", "HFMA2", "HADD2", "HMUL2"),
    "mem": ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "LD", "ST", "ATOM", "RED",
            "LDGSTS", "LDGDEPBAR", "DEPBAR"),
    "ctrl": ("BRA", "BAR", "EXIT", "BSSY", "BSYNC", "WARPSYNC", "NOP", "CALL", "RET",
             "YIELD", "BPT", "ERRBAR", "MEMBAR"),
    "move": ("MOV", "S2R", "S2UR", "CS2R", "R2UR", "SHFL", "VOTE"),
}


def sass_counts(code):
    """A kernel's static SASS instructions (``sass``) by pipe, and its most
    frequent ALU opcodes."""
    pipes, alu = {k: 0 for k in ("alu", *SASS_PIPES, "uniform")}, {}
    for ins in code:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
        base = op.split(".")[0]
        pipe = next((k for k, ops in SASS_PIPES.items() if base in ops),
                    "uniform" if base.startswith("U") else "alu")
        pipes[pipe] += 1
        if pipe == "alu":
            alu[base] = alu.get(base, 0) + 1
    top = ", ".join(f"{k} {n}" for k, n in sorted(alu.items(), key=lambda kv: -kv[1])[:8])
    return f"{len(code)} instructions: " + ", ".join(f"{k} {n}" for k, n in pipes.items()) + \
        f" (ALU: {top})"


def sass_differs(repo_so, form_so):
    """(kernels of the package's build, the kernels whose SASS differs in
    the form's or that only one of them has)."""
    a, b = sass(repo_so), sass(form_so)
    return len(a), sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))


class PreRing:
    """A library of ``csrc/flooding.cu`` of before the ring kernel, under
    the package's calls: its resident decode takes no stage size (the
    argument before the stream is dropped), and it has no
    ``ldpc_ring_block_bytes``."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def ldpc_resident_flooding_decode(self, *args):
        return self.lib.ldpc_resident_flooding_decode(*args[:-2], args[-1])

    def ldpc_ring_block_bytes(self, dev):
        return fused_bp2.flooding_lib().ldpc_ring_block_bytes(dev)


def bind_flooding_form(lib):
    """``fused_bp2.bind_flooding`` for a form's ``flooding`` library; one of
    before the ring kernel is declared with its own resident decode and
    called through ``PreRing``."""
    if hasattr(lib, "ldpc_ring_block_bytes"):
        return fused_bp2.bind_flooding(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_resident_flooding_decode.argtypes = [p] * 7 + [i] * 7 + [i, i, f, f, i, p]
    lib.ldpc_resident_flooding_decode.restype = i
    lib.ldpc_flooding_error_string.argtypes = [i]
    lib.ldpc_flooding_error_string.restype = ctypes.c_char_p
    wrapped = PreRing(lib)
    try:
        dims = [i] * 6
        lib.ldpc_fused_check.argtypes = [p, p, p] + dims + [i, f, f, i, i, p]
        lib.ldpc_fused_var.argtypes = [p, p, p, p, p] + dims + [f, i, i, p]
        lib.ldpc_fused_syndrome.argtypes = [p] * 6 + [i, p, p] + dims + [i, p]
        for fn in (lib.ldpc_fused_check, lib.ldpc_fused_var, lib.ldpc_fused_syndrome):
            fn.restype = i
    except AttributeError:
        pass
    return wrapped


def bind_form(bind, lib):
    """``bind(lib)`` for a form's library: one that predates the phase
    instances of a flooding source lacks their functions, which the
    package's binders declare after the resident kernel's."""
    try:
        return bind(lib)
    except AttributeError:
        return lib


def per_frame_check(lib, v2c, layout, rule):
    """The check phase of a form of before the lane form, through its own C
    interface (no degree bucket)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_fused_check.argtypes = [p, p, p] + [i] * 6 + [f, f, i, i, p]
    tables, dims, stream = fused_bp2.launch_args(v2c, layout, rule)
    c2v = torch.empty_like(v2c)
    err = lib.ldpc_fused_check(v2c.data_ptr(), c2v.data_ptr(), tables, *dims, rule.big,
                               rule.scale, fused_bp2._MSG_DTYPES[rule.storage_dtype],
                               fused_bp2.PHASE_THREADS, stream)
    if err:
        raise RuntimeError(f"per-frame check launch failed: {err}")
    return c2v


def with_phases(lib, fn, *args):
    """fn(*args) with ``fused_bp2``'s min-sum phase wrappers launching
    ``lib``."""
    saved = fused_bp2.flooding_lib
    fused_bp2.flooding_lib = lambda: lib
    try:
        return fn(*args)
    finally:
        fused_bp2.flooding_lib = saved


def run_streaming(forms, lg, llrs, reps, card, result):
    """Holds every form's min-sum streaming kernels to the package's and
    times them in turns: the sweep on the HLMinsumbf16 tiles, the check and
    variable phases on the Minsumbf16 and Minsumf32 tiles. ``forms``: name
    -> (lane form, sweep library, phase library)."""
    qv0, _, layout, rule = tile_inputs(lg, make_arithmetic("HLMinsumbf16")[1], llrs)
    rcv0 = torch.zeros((qv0.shape[0], layout.E, layout.Z, 4), dtype=rule.storage_dtype,
                       device=qv0.device)

    def sweep(form, state):
        lane, lib, _ = forms[form]
        n = None if lane else PER_FRAME_SWEEP_THREADS
        return with_lib(fused_layered, "_lib", lib, n and (n, n),
                    fused_layered.fused_layered_iteration,
                        *state, layout, rule)

    hold_and_time_sweep(sweep, forms, qv0, rcv0,
                        "streaming fused_layered_iteration HLMinsumbf16", reps, card, result)
    for name in ("Minsumbf16", "Minsumf32"):
        q, _, layout, rule = flooding_tiles(lg, make_arithmetic(name)[1], llrs)
        v2c0 = fused_bp2.fused_var(None, q, layout, rule)[0]
        c2v = fused_bp2.fused_check(v2c0, layout, rule)
        checks, variables = {}, {}
        for form, (lane, _, lib) in forms.items():
            if lane:
                checks[form] = lambda lib=bind_form(bind_flooding_form, lib): with_phases(
                    lib, fused_bp2.fused_check, v2c0, layout, rule)
            else:
                checks[form] = lambda lib=lib: per_frame_check(lib, v2c0, layout, rule)
            # the variable phase kept its C interface
            variables[form] = lambda lib=bind_form(bind_flooding_form, lib): with_phases(
                lib, fused_bp2.fused_var, c2v, q, layout, rule)
        for kernel, fns in (("fused_check", checks), ("fused_var", variables)):
            hold_and_time(fns, f"streaming {kernel} {name}", reps, card, result)


def hold_and_time_sweep(sweep, forms, qv0, rcv0, what, reps, card, result, regs={}):
    """Holds one sweep of every form (``sweep(form, (qv, rcv))``, in place)
    from the same planes to the package's, bit for bit, then times each
    form's sweeps in turns, each decoding on from its own planes."""
    ref = sweep("repo", (qv0.clone(), rcv0.clone()))
    for form in forms:
        for a, b in zip(sweep(form, (qv0.clone(), rcv0.clone())), ref, strict=True):
            assert torch.equal(a, b), f"{what}: {form} differs from repo"
    states = {form: (qv0.clone(), rcv0.clone()) for form in forms}
    ms = turns({form: lambda form=form: sweep(form, states[form]) for form in forms}, reps)
    result[what if BATCH == FLAGSHIP_BATCH else f"{what} B={BATCH}"] = ms
    print(f"[{card}] {what}, B={BATCH}: all forms equal; "
          + ", ".join(f"{k} {v:.3f} ms" + (f" ({regs[k]})" if k in regs else "")
                      for k, v in ms.items())
          + f" (one sweep, in place, in turns, median of {reps})")


def run_sweep(source, built, block, lg, llrs, reps, card, result):
    """Times one sweep of an i8 or float sweep source in every form, in
    turns, on the flagship's tiles of its name."""
    wrapper, getter, bind = SWEEPS[source]
    for name in SOURCE_NAMES[source]:
        qv0, _, layout, rule = tile_inputs(lg, make_arithmetic(name)[1], llrs)
        rcv0 = torch.zeros((qv0.shape[0], layout.E, layout.Z, 4), dtype=rule.storage_dtype,
                           device=qv0.device)
        libs = {form: bind_form(bind, lib) for form, lib in built.items() if form != "base"}

        def sweep(form, state):
            return with_lib(fused_layered, getter, libs[form], block.get(form),
                            getattr(fused_layered, wrapper), *state, layout, rule)

        hold_and_time_sweep(sweep, libs, qv0, rcv0, f"{source} {wrapper} {name}", reps, card,
                            result, registers(source, libs, wrapper, rule))


def hold_and_time(fns, what, reps, card, result, regs={}):
    """Holds every form's outputs (``fns``: name -> fn, "repo" among them)
    to the package's, bit for bit, then times them in turns into
    ``result[what]``."""
    def outputs(fn):
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    ref = outputs(fns["repo"])
    for form, fn in fns.items():
        for a, b in zip(outputs(fn), ref, strict=True):
            assert torch.equal(a, b), f"{what}: {form} differs from repo"
    ms = turns(fns, reps)
    result[what if BATCH == FLAGSHIP_BATCH else f"{what} B={BATCH}"] = ms
    print(f"[{card}] {what}, B={BATCH}: all forms equal; "
          + ", ".join(f"{k} {v:.3f} ms" + (f" ({regs[k]})" if k in regs else "")
                      for k, v in ms.items())
          + f" (in turns, median of {reps})")


#: the check and variable phase wrappers of the flooding sources that hold
#: i8 or float phase instances, and their library getter in ``fused_bp2``
PHASES = {
    "flooding_i8": ("fused_check_i8", "fused_var_i8", "flooding_i8_lib"),
    "flooding_f32": ("fused_check_float", "fused_var_float", "flooding_float_lib"),
    "flooding_f64": ("fused_check_float", "fused_var_float", "flooding_float_lib"),
}


def run_phases(source, built, block, lg, llrs, reps, card, result):
    """Times the check and variable phases of ``source``'s name in every
    form, in turns, on the flagship's planes after one iteration: the
    check phase on its v2c, the variable phase on its c2v."""
    check, var, getter = PHASES[source]
    bind = PLAN[source][0][5]
    for name in SOURCE_NAMES[source]:
        q, _, layout, rule = flooding_tiles(lg, make_arithmetic(name)[1], llrs)
        v2c = fused_bp2.fused_var(None, q, layout, rule)[0]
        v2c = fused_bp2.fused_var(fused_bp2.fused_check(v2c, layout, rule), q, layout, rule)[0]
        c2v = fused_bp2.fused_check(v2c, layout, rule)
        for kernel, args in ((check, (v2c, layout, rule)), (var, (c2v, q, layout, rule))):
            fns = {form: lambda lib=bind_form(bind, lib), form=form, args=args: with_lib(
                       fused_bp2, getter, lib, block.get(form), getattr(fused_bp2, kernel), *args)
                   for form, lib in built.items() if form != "base"}
            hold_and_time(fns, f"{source} {kernel} {name}", reps, card, result,
                          registers(source, fns, kernel, rule))


def run_probes(built, reps, card, result):
    """Holds every form's copy stream (P1 at ``copybw.CONFIGS``, P4's copy
    at Bt = 128, 256, 512) to its plain version, bit for bit, then times
    the forms and the library call in turns, each a chain of launches
    (``probes._kernels.turns``); then P2 roll the same way at the tool's
    shape, without a library call; prints each form's stream and roll
    kernels' nvcc report."""
    libs = {form: probe_kernels.bind(lib) for form, lib in built.items()}
    for form in libs:
        log = LOGS.get(("probes", form))
        found = ptxas_report(str(log)) if log else {}
        print(f"probes {form}: " + "; ".join(
            f"{k} {report_text(v)}" for k, v in sorted(found.items())
            if "stream" in k or "copy" in k or "roll" in k))
    cases = []
    for i, (P, Z, Bt, G, dtype) in enumerate(copybw.CONFIGS):
        src = seeded_cuda((G, P, Z, Bt), dtype, 100 + i, scale=300.0)
        cases.append((f"P1 stream P={P} Z={Z} Bt={Bt} G={G} {str(dtype)[6:]}", src,
                      copybw.stream_slabs, copybw.stream_slabs_reference,
                      ("src + 1", lambda src=src: src + 1)))
    for bt in (128, 256, 512):
        src = seeded_cuda((v2.B // bt, v2.G, v2.D, v2.Z, bt), torch.bfloat16, bt)
        out = torch.empty_like(src)
        cases.append((f"P4 copy Bt={bt}", src, v2.plane_copy, v2.plane_copy_reference,
                      ("Tensor.copy_", lambda src=src, out=out: out.copy_(src))))
    for what, src, wrapper, plain, (library, call) in cases:
        ref = plain(src)
        for form, lib in libs.items():
            got = with_lib(probe_kernels, "lib", lib, None, wrapper, src)
            assert torch.equal(got, ref), f"{what}: {form} differs from the plain version"
        del ref, got
        fns = {form: lambda lib=lib: with_lib(probe_kernels, "lib", lib, None, wrapper, src)
               for form, lib in libs.items()}
        fns[library] = call
        found = probe_kernels.turns(fns, 20, reps)
        result[what] = {name: t.ms for name, t in found.items()}
        print(f"[{card}] {what}: all forms equal; " + ", ".join(
            f"{name} {t.ms:.4f} ms ({2 * src.nbytes / t.ms / 1e6:.1f} GB/s, host "
            f"{t.host_ms:.4f} ms a launch, gap {t.gap_ms:.4f})" for name, t in found.items())
            + f" (chains of 20 in turns, median of {reps})")
    # P2 roll at the tool's 132 planes: held at ROLL_CHECK_ROUNDS, timed at
    # the tool's 32768, chains of 5 (no library call computes it)
    x = vpu_peak.planes(vpu_peak.PLANES)
    ref = vpu_peak.alu_chain_reference(x, "roll", ROLL_CHECK_ROUNDS)
    for form, lib in libs.items():
        got = with_lib(probe_kernels, "lib", lib, None, vpu_peak.alu_chain, x, "roll",
                       ROLL_CHECK_ROUNDS)
        assert torch.equal(got, ref), f"P2 roll: {form} differs from the plain version"
    del ref, got
    fns = {form: lambda lib=lib: with_lib(probe_kernels, "lib", lib, None, vpu_peak.alu_chain,
                                          x, "roll")
           for form, lib in libs.items()}
    found = probe_kernels.turns(fns, 5, reps)
    what = f"P2 roll {vpu_peak.PLANES} planes x {vpu_peak.R * vpu_peak.K} rounds"
    result[what] = {name: t.ms for name, t in found.items()}
    rounds_done = x.numel() * vpu_peak.R * vpu_peak.K
    print(f"[{card}] {what}: all forms equal at {ROLL_CHECK_ROUNDS} rounds; " + ", ".join(
        f"{name} {t.ms:.3f} ms ({rounds_done / t.ms / 1e9:.2f} T rounds/s)"
        for name, t in found.items()) + f" (chains of 5 in turns, median of {reps})")
    torch.cuda.empty_cache()


def run_cell(workload, sources, libs, block, reps, card, result):
    """Every form of each source of the schedule of a benchmark cell's
    decoder, on the LLRs of the cell's step 0 at seed 7
    (``portbench/harness.build_test``, ``BerTest.channel_llrs``), its
    decoder's name alone, held and timed in turns (``run_source``); the
    registers printed are those of the instance of the cell's degree
    bucket. Prints the step's tile-iterations and mean iterations."""
    global BATCH
    from ldpc_toolbox_torch.simulation.ber import step_generator
    from portbench import harness, lookup

    root = pathlib.Path(__file__).resolve().parent.parent
    cell = lookup.load_cell(root / "BENCHMARK.json", workload)
    test = harness.build_test(cell.config, torch.device("cuda"))
    gen = step_generator(7, 0, 0, "cuda")
    msg = torch.randint(0, 2, (test.p.batch_size, test.k), generator=gen, dtype=torch.uint8,
                        device="cuda")
    llrs = test.channel_llrs(test.encode(msg), test.noise_sigma(cell.traffic["ebn0_db"]), gen)
    name = cell.config["decoder"]
    schedule = "layered" if name.startswith("HL") else "flooding"
    tiles = (tile_inputs if schedule == "layered" else flooding_tiles)(
        test.graph, test.arithmetic, llrs)
    bucket = next(b for b in (8, 16, 32, 64) if tiles[2].max_chk_degree <= b)
    iters = resident_flooding.resident_flooding_decode(*tiles, FLAGSHIP_ITERS)[1] \
        if schedule == "flooding" else None
    if iters is not None:
        print(f"[{card}] {workload}: {int(iters.amax(dim=1).sum())} tile-iterations, "
              f"{float(iters.float().mean()):.3f} iterations a frame, bucket {bucket}")
    BATCH = test.p.batch_size
    for source in sources:
        if source in PLAN and PLAN[source][0][0] == schedule and source not in SOURCE_NAMES:
            run_source(source, libs[source], block, test.graph, llrs, reps, card, result,
                       names=[name], tag=f" {workload}", bucket=bucket)


def run_source(source, built, block, lg, llrs, reps, card, result, names=None, tag="",
               bucket=8):
    """Holds every form of ``source`` to the package's and times them, on
    each of its tile sets; the times go into ``result``. ``names``: the
    decoder names to run instead of the source's (a cell's; its resident
    decodes alone), ``tag`` added to each line's label, ``bucket`` the
    degree bucket of the instance whose registers are printed."""
    if source in SWEEPS:
        run_sweep(source, built, block, lg, llrs, reps, card, result)
        return
    for schedule, module, getter, kernel, other, bind in PLAN[source]:
        tiles = tile_inputs if schedule == "layered" else flooding_tiles
        wrapper = getattr(module, kernel)
        fns_of = {}
        for name in names or SOURCE_NAMES.get(source, NAMES[schedule]):
            t = tiles(lg, make_arithmetic(name)[1], llrs)
            fns = {}
            for form, lib in built.items():
                if form == "base" and source == "flooding":
                    fns[form] = lambda lib=lib, t=t: base_flooding(lib, *t, FLAGSHIP_ITERS)
                else:
                    n = block.get(form, (BASE_THREADS[source],) * 2 if form == "base" else None)
                    fns[form] = lambda lib=bind_form(bind or bind_flooding_form, lib), n=n, t=t: with_lib(
                        module, getter, lib, n, wrapper, *t, FLAGSHIP_ITERS)
            if other is not None:
                fns[other.__name__] = lambda t=t: other(*t, FLAGSHIP_ITERS)
            fns_of[name] = fns
        for name, fns in fns_of.items():
            hold_and_time(fns, f"{source} {kernel} {name}{tag}", reps, card, result,
                          registers(source, fns, kernel, make_rule(name), bucket))
    if source in PHASES and not names:
        run_phases(source, built, block, lg, llrs, reps, card, result)


if __name__ == "__main__":
    main()
