"""Time forms of kernel sources in turns on one GPU.

    python3 tools/compare_forms.py --source SOURCE [--source SOURCE ...]
        [--form NAME=DIR[:THREADS] ...] [--base DIR] [--reps 5] [--batch 1024 ...]

SOURCE is one of compressed, flooding, resident_layered (min-sum),
resident_layered_i8, flooding_i8 (the i8 instances), resident_layered_f32,
resident_layered_f64, flooding_f32, flooding_f64 (the float-rule instances),
fused_layered_i8, fused_layered_f32, fused_layered_f64 (the streaming
sweep's i8 and float instances), or streaming (the min-sum streaming
kernels: the layered sweep of ``csrc/fused_layered.cu`` and the check and
variable phases of ``csrc/flooding.cu``). A form is a directory holding a
version of the kernel sources (``csrc/<source>.cu`` and the headers it
includes), built here with the package's nvcc flags; "repo" is the package's
own ``csrc/``, built into the package's ``build/`` as its wrappers build it.
``--form`` forms share the package's C interface and run at the package's
block sizes, or at THREADS a block where given (every lane kernel of the
form, the f32 float rules' layered frame pairs and the i8 instances among
them: a form of before the f64 float rules' (lane, frame) units runs its
f64 flooding kernels at 256, and so does a form of before the i8 rules'
blocks of 512 and 384 run its i8 kernels). ``--base`` names a directory holding the sources
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

``--batch`` times every source at other batch sizes too, one run after
the other on the same builds (528 frames: one tile an SM of the card's 132,
against the flagship's two).

Prints the card's name and power limit, a line a tile set with each form's
time and, from nvcc's report of its build, the registers and spill-store
bytes of the flagship instance it ran (bucket 8, the name's rule), and one
JSON line with every time in milliseconds.
"""

import argparse
import ctypes
import functools
import json
import pathlib
import re
import shutil
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
from ldpc_toolbox_torch.ops import (  # noqa: E402
    _build,
    fused_bp2,
    fused_layered,
    resident_compressed,
    resident_flooding,
    resident_layered,
)

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
         resident_compressed.compressed_flooding_decode, fused_bp2.bind_flooding),
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
    phases, the f64 flooding kernels and the i8 instances)."""
    patches = [(module, getter, lambda *_: lib)]
    if threads is not None:
        patches += [(m, name, threads) for m, name in (
            (module, "LANE_THREADS"), (module, "I8_LAYERED_THREADS"),
            (fused_bp2, "PHASE_THREADS"), (fused_bp2, "F64_UNIT_THREADS"),
            (fused_bp2, "I8_FLOODING_THREADS")) if hasattr(m, name)]
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


def instance(wrapper, rule):
    """The demangled name (``ldpc::`` and spaces dropped) of the flagship
    instance (degree bucket 8) that ``wrapper`` launches under ``rule``."""
    kernel = next(k for w, k in KERNEL_OF.items() if wrapper.startswith(w))
    if fused_bp2.is_i8(rule):
        tag = f"I8Rule<{rule.kind}>"
    elif fused_bp2.is_float_rule(rule):
        tag = f"FloatRule<{_CTYPE[rule.storage_dtype]},{rule.kind}>"
    else:
        ctype = _CTYPE[rule.storage_dtype]
        tag = ctype if kernel.startswith("compressed") else f"MinSumRule<{ctype}>"
    return f"{kernel}<{tag}>" if kernel == "fused_var_kernel" else f"{kernel}<8,{tag}>"


@functools.cache
def ptxas_report(log):
    """{kernel (demangled, ``ldpc::`` and spaces dropped): (registers,
    spill-store bytes)} of an nvcc ``-Xptxas -v`` report."""
    regs, spills, fn = {}, {}, None
    for line in pathlib.Path(log).read_text().splitlines():
        if m := re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line):
            fn = m.group(1)
        elif fn and (m := re.search(r"(\d+) bytes spill stores", line)):
            spills[fn] = int(m.group(1))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            regs[fn] = int(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(regs), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    short = (re.sub(r"\(anonymous namespace\)::|ldpc::", "", n).split("(")[0] for n in names)
    return {re.sub(r"\s", "", n).removeprefix("void"): (r, spills.get(k, 0))
            for n, (k, r) in zip(short, regs.items())}


def make_rule(name):
    """The rule policy of a decoder name."""
    return fused_bp2.rule_for(make_arithmetic(name)[1])


def registers(source, forms, wrapper, rule):
    """{form: "R regs, S B spill"} of the instance each form of ``source``
    ran, from nvcc's report of its build (empty where no report is kept)."""
    out = {}
    for form in forms:
        log = LOGS.get((source, form))
        found = ptxas_report(str(log)).get(instance(wrapper, rule)) if log else None
        if found:
            out[form] = f"{found[0]} regs, {found[1]} B spill"
    return out


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
                   choices=sorted(PLAN) + sorted(SWEEPS) + ["streaming"])
    p.add_argument("--form", action="append", default=[], metavar="NAME=DIR[:THREADS]")
    p.add_argument("--base", metavar="DIR")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--batch", type=int, action="append",
                   help=f"frames a decode (repeatable; default {FLAGSHIP_BATCH})")
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
            block[name] = int(n)
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

    lg = lifted_graph_for(Code.R1_2)
    result = {"card": card}
    for batch in args.batch or [FLAGSHIP_BATCH]:
        BATCH = batch
        llrs = channel_llrs(lg.n, batch, sigma_at(R1_2_RATE, FLAGSHIP_EBN0), seed=0)
        for source in sources:
            run_source(source, libs[source], block, lg, llrs, args.reps, card, result)
    if "streaming" in args.source:
        streaming = {"repo": (True, fused_layered._lib(), fused_bp2.flooding_lib())}
        for form, d in forms.items():
            lane = (pathlib.Path(d) / "fused_layered.cu").exists()
            sweep, phases = (lib for (_, name, _), lib in zip(jobs, built)
                             if name in (f"{form}-sweep", f"{form}-phases"))
            streaming[form] = (lane, fused_layered.bind(sweep), phases)
        run_streaming(streaming, lg, llrs, args.reps, card, result)
    print(json.dumps(result))


def sass(so):
    """{kernel: its SASS instructions} of the library ``so`` (addresses
    and encodings dropped), demangled names."""
    dump = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                           "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)):
            kernels[name].append(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(kernels), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    short = (re.sub(r"\(anonymous namespace\)::|ldpc::", "", n).split("(")[0] for n in names)
    return {n: kernels[k] for n, k in zip(short, kernels)}


def sass_differs(repo_so, form_so):
    """(kernels of the package's build, the kernels whose SASS differs in
    the form's or that only one of them has)."""
    a, b = sass(repo_so), sass(form_so)
    return len(a), sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))


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
        return with_lib(fused_layered, "_lib", lib, n, fused_layered.fused_layered_iteration,
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
                checks[form] = lambda lib=bind_form(fused_bp2.bind_flooding, lib): with_phases(
                    lib, fused_bp2.fused_check, v2c0, layout, rule)
            else:
                checks[form] = lambda lib=lib: per_frame_check(lib, v2c0, layout, rule)
            # the variable phase kept its C interface
            variables[form] = lambda lib=bind_form(fused_bp2.bind_flooding, lib): with_phases(
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


def run_source(source, built, block, lg, llrs, reps, card, result):
    """Holds every form of ``source`` to the package's and times them, on
    each of its tile sets; the times go into ``result``."""
    if source in SWEEPS:
        run_sweep(source, built, block, lg, llrs, reps, card, result)
        return
    for schedule, module, getter, kernel, other, bind in PLAN[source]:
        tiles = tile_inputs if schedule == "layered" else flooding_tiles
        wrapper = getattr(module, kernel)
        fns_of = {}
        for name in SOURCE_NAMES.get(source, NAMES[schedule]):
            t = tiles(lg, make_arithmetic(name)[1], llrs)
            fns = {}
            for form, lib in built.items():
                if form == "base" and source == "flooding":
                    fns[form] = lambda lib=lib, t=t: base_flooding(lib, *t, FLAGSHIP_ITERS)
                else:
                    n = block.get(form, BASE_THREADS[source] if form == "base" else None)
                    fns[form] = lambda lib=bind_form(bind, lib), n=n, t=t: with_lib(
                        module, getter, lib, n, wrapper, *t, FLAGSHIP_ITERS)
            if other is not None:
                fns[other.__name__] = lambda t=t: other(*t, FLAGSHIP_ITERS)
            fns_of[name] = fns
        for name, fns in fns_of.items():
            hold_and_time(fns, f"{source} {kernel} {name}", reps, card, result,
                          registers(source, fns, kernel, make_rule(name)))
    if source in PHASES:
        run_phases(source, built, block, lg, llrs, reps, card, result)


if __name__ == "__main__":
    main()
