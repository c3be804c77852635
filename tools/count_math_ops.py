"""Operations the float rules' transcendental steps execute on Hopper.

    python3 tools/count_math_ops.py [--n 1048576] [--seed 0]

The float rules (``csrc/float_rules.cuh``) spend their arithmetic in five
steps that call the CUDA math library: ``phi`` (of a magnitude), the
MinstarApprox fold ``minstar_approx``, Aminstar's ``minstar_full`` and
Tanh's ``tanh_half`` and ``atanh2``. A math routine branches: a call runs
one path, and its slow paths for special inputs (tiny, huge or non-finite
arguments) run only for those. So a static instruction count charges a
call with paths it does not take.

This tool counts the instructions a call executes. For each step, in f32
and in f64, it compiles a probe kernel (one argument a thread, the step
between two inline-asm markers that carry its operands, so the compiler
cannot move the step's arithmetic across them) to PTX with the package's
flags (sm_90a, -O3, no fast math), walks the PTX's control-flow graph from
the begin marker to the end marker, and adds to every basic block of that
region one counter increment a class: ``f32``, ``f64`` (arithmetic, compares
and selects of that type on the FP32 or FP64 units), ``sfu`` (the MUFU
approximations: ex2, lg2, rcp, rsqrt, sqrt, sin, cos, tanh .approx) and
``int`` (every other instruction but moves, loads, stores and branches;
negations, absolute values and conversions are counted here, on the
fastest pipe, since ptxas folds many of them into operand modifiers). It
assembles the instrumented PTX with ptxas and runs it through the CUDA
driver API on ``--n`` arguments over the range the decoders' messages take:
magnitudes in (0, 300], half log-uniform from 1e-6, half uniform, with
random signs where a step takes signed values (Tanh's products are the
tanh of half a magnitude). PTX instructions are counted, not SASS: ptxas
expands a few (a division, a full-precision reciprocal) into several, so
the counts stay at or below what runs.

Prints, per type and step, each class's fewest, mean and most executed
instructions a call over the arguments, then one JSON line with the
fewest: ``chip_smoke.py`` charges each call of a step these (``STEP_OPS``),
so the bound it computes stays a least time for any argument in the range.
With ``--rate`` it also times each probe, uninstrumented, on the same
arguments (CUDA events, median of 5 launches) and prints its calls a
second: the rate the card reaches for a step alone, a thread a call,
against which a rule kernel's share of its bound can be read.
The i8 rules' steps (``csrc/i8.cuh``: the correction table ``tab4``,
the folds ``minstar_approx4`` and ``minstar_full4`` and the partial hard
limit ``phl4``, each on a word of four frames, a byte a frame) are counted
from SASS instead, since ptxas expands the PTX of byte-SIMD operations
into sequences of its own: each step has a probe kernel that loads two
words, stores the step's word and the second word, and an identity probe
that stores both words as loaded. The steps are branch-free, so the
static count of each probe's SASS (``cuobjdump -sass`` of its cubin, no
NOP, BRA or EXIT counted) less the identity probe's is exactly what a call
executes (a marker in the code does not serve: ptxas schedules register
arithmetic across an inline-asm marker, which carries no data in the
SASS). The instructions are classed by the pipe they issue to: ``f32``
for IMAD and its kin (the FMA pipe), ``int`` for the rest (IADD3, LOP3,
SHF, PRMT, LEA, IMNMX, ISETP, SEL, VABSDIFF4, VIMNMX, ...). ``--i8-form
NAME=DIR`` counts the steps of another ``i8.cuh`` (a directory with it and
the headers it includes) beside the package's. With ``--rate`` each i8
step is timed alone on random words of bytes in [0, 127]: a thread a chain
of 64 dependent calls (tab4 and phl4 xor the second word into their
argument, one LOP3 a call more), every thread of the card busy, words a
second over the chain's calls.

Needs a CUDA device, nvcc and ptxas (and cuobjdump for the i8 steps).
"""

import argparse
import ctypes
from collections import Counter
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "ldpc_toolbox_torch" / "csrc"
CLASSES = ("f32", "f64", "sfu", "int")
#: step: (its arity, the expression on a (and b) in T with the parameters
#: clamp and prod_max)
STEPS = {
    "phi": (1, "phi(a)"),
    "minstar_approx": (2, "minstar_approx(a, b)"),
    "minstar_full": (2, "minstar_full(a, b)"),
    "tanh_half": (1, "tanh_half(a, clamp)"),
    "atanh2": (1, "atanh2(a, prod_max)"),
}
TYPES = {"float": ("f32", "f"), "double": ("f64", "d")}
#: Tanh's clamps by type (ops/fused_bp2.py TanhRule)
CLAMP = {"float": 9.0, "double": 18.0}
NOT_OPS = {"mov", "cvta", "ld", "st", "bra", "ret", "exit", "bar", "membar",
           "prefetch", "red", "atom"}
SFU = {"ex2", "lg2", "rcp", "rsqrt", "sqrt", "sin", "cos", "tanh"}
FLOAT_ARITH = {"add", "sub", "mul", "fma", "mad", "div", "min", "max", "setp",
               "set", "selp", "rcp", "sqrt", "rsqrt"}
BEGIN, END = "probe begin", "probe end"
THREADS = 256
#: the i8 steps: (their arity, their expression on the words a and b)
I8_STEPS = {
    "tab4": (1, "tab4(a)"),
    "minstar_approx4": (2, "minstar_approx4(a, b)"),
    "minstar_full4": (2, "minstar_full4(a, b)"),
    "phl4": (1, "phl4(a)"),
}
#: the chain each --rate thread runs: (argument, result) of one call
I8_CHAIN = {"tab4": "tab4(a) ^ b", "minstar_approx4": "minstar_approx4(a, b)",
            "minstar_full4": "minstar_full4(a, b)", "phl4": "phl4(a) ^ b"}
I8_CHAIN_CALLS = 64
#: SASS opcodes that issue to the FMA pipe (classed "f32"), and those that
#: are not counted
SASS_FMA = ("IMAD", "FFMA", "FMUL", "FADD")
SASS_SKIPPED = {"NOP", "BRA", "EXIT", "RET"}


def _tool(name):
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        sys.exit(f"{name} not found")
    return found


def source():
    """The probe kernels: k_<step>_<f32|f64>(a, b, y, counts, n, clamp,
    prod_max)."""
    lines = ['#include "float_rules.cuh"', "using namespace ldpc;"]
    for t, (suffix, c) in TYPES.items():
        for step, (arity, expr) in STEPS.items():
            ops = f'"+{c}"(a), "+{c}"(b)' if arity == 2 else f'"+{c}"(a)'
            load = f"{t} a = x[i], b = z[i];" if arity == 2 else f"{t} a = x[i];"
            lines.append(
                f'extern "C" __global__ void k_{step}_{suffix}(const {t}* x, const {t}* z, '
                f"{t}* y, unsigned long long* counts, int n, {t} clamp, {t} prod_max) {{\n"
                "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
                "  if (i >= n) return;\n"
                f"  {load}\n"
                f'  asm volatile("// {BEGIN}" : {ops});\n'
                f"  {t} r = {expr};\n"
                f'  asm volatile("// {END}" : "+{c}"(r));\n'
                "  y[i] = r;\n}")
    return "\n".join(lines) + "\n"


def classify(op):
    """The class of a PTX instruction by its opcode (guard stripped), or
    None for moves, loads, stores and branches."""
    parts = op.split(".")
    base = parts[0]
    if base in NOT_OPS:
        return None
    if base == "call":
        raise SystemExit("a probe calls a function: its instructions would go uncounted")
    if base in SFU and "approx" in parts:
        return "sfu"
    if base in FLOAT_ARITH:
        if "f64" in parts:
            return "f64"
        if "f32" in parts:
            return "f32"
    return "int"


def _opcode(text):
    return re.sub(r"^@!?%\w+\s+", "", text).split()[0]


def function_body(ptx, name):
    """(start, end) line indices of the body of entry ``name``: from the
    line after its opening brace to its closing brace."""
    lines = ptx.splitlines()
    head = next(i for i, ln in enumerate(lines) if re.search(rf"\.entry {name}\(", ln))
    start = next(i for i in range(head, len(lines)) if lines[i] == "{") + 1
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    return lines, start, end


def instrument(ptx, name):
    """``ptx`` with entry ``name`` counting, per thread, the instructions it
    executes between the markers, by class, stored at counts[i * 4 + c]
    (its fourth parameter) when the thread passes the end marker."""
    lines, start, end = function_body(ptx, name)
    # items: ("label", name) | ("instr", text, class) | ("mark", BEGIN/END)
    items = []
    for i in range(start, end):
        raw = lines[i].strip()
        if BEGIN in raw:
            items.append(("mark", BEGIN, i))
            continue
        if END in raw:
            items.append(("mark", END, i))
            continue
        text = raw.split("//")[0].strip()
        m = re.fullmatch(r"(\$?[\w$]+):", text)
        if m:
            items.append(("label", m.group(1), i))
        elif text and not text.startswith(".") and text not in ("{", "}"):
            items.append(("instr", text, i))
    # basic blocks: split at labels and after branches and returns
    blocks, cur = [], []
    for it in items:
        if it[0] == "label" and cur:
            blocks.append(cur)
            cur = []
        cur.append(it)
        if it[0] == "instr" and _opcode(it[1]).split(".")[0] in ("bra", "ret", "exit"):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    label_block = {it[1]: b for b, blk in enumerate(blocks) for it in blk if it[0] == "label"}

    def successors(b):
        last = next((it for it in reversed(blocks[b]) if it[0] == "instr"), None)
        nxt = [b + 1] if b + 1 < len(blocks) else []
        if last is None:
            return nxt
        op = _opcode(last[1]).split(".")[0]
        guarded = last[1].startswith("@")
        if op == "bra":
            target = [label_block[last[1].split()[-1].rstrip(";")]]
            return target + nxt if guarded else target
        if op in ("ret", "exit"):
            return nxt if guarded else []
        return nxt

    begins = [(b, j) for b, blk in enumerate(blocks) for j, it in enumerate(blk)
              if it[0] == "mark" and it[1] == BEGIN]
    if len(begins) != 1:
        raise SystemExit(f"{name}: {len(begins)} begin markers")
    # walk the region: (block, first item) from the begin marker to the
    # end markers; adds[line] = counts to add after that line
    adds, seen, todo = {}, set(), [(begins[0][0], begins[0][1] + 1)]
    while todo:
        b, j = todo.pop()
        if (b, j) in seen:
            continue
        seen.add((b, j))
        counts, stopped = dict.fromkeys(CLASSES, 0), False
        for it in blocks[b][j:]:
            if it[0] == "mark" and it[1] == END:
                stopped = True
                break
            if it[0] == "instr":
                cls = classify(_opcode(it[1]))
                if cls:
                    counts[cls] += 1
        at = blocks[b][j - 1][2] if j else blocks[b][0][2] - 1
        if blocks[b][0][0] == "label" and j == 0:
            at = blocks[b][0][2]
        adds[at] = counts
        if not stopped:
            todo.extend((s, 0) for s in successors(b))
    ends = [it[2] for blk in blocks for it in blk if it[0] == "mark" and it[1] == END]
    out = []
    # the function's register declarations open its body (scoped blocks
    # inside it declare more)
    regs = start
    while lines[regs + 1].strip().startswith(".reg") or not lines[regs + 1].strip():
        regs += 1
    for i, ln in enumerate(lines):
        out.append(ln)
        if i == regs:
            out += ["\t.reg .b64 \t%icn<4>;", "\t.reg .b32 \t%icr<3>;", "\t.reg .b64 \t%icd<2>;"]
            out += [f"\tmov.u64 \t%icn{c}, 0;" for c in range(len(CLASSES))]
        if i in adds:
            out += [f"\tadd.s64 \t%icn{c}, %icn{c}, {n};"
                    for c, n in enumerate(adds[i].values()) if n]
        if i in ends:
            out += [f"\tld.param.u64 \t%icd0, [{name}_param_3];",
                    "\tcvta.to.global.u64 \t%icd0, %icd0;",
                    "\tmov.u32 \t%icr0, %ctaid.x;", "\tmov.u32 \t%icr1, %ntid.x;",
                    "\tmov.u32 \t%icr2, %tid.x;",
                    "\tmad.lo.s32 \t%icr0, %icr0, %icr1, %icr2;",
                    f"\tmul.wide.u32 \t%icd1, %icr0, {8 * len(CLASSES)};",
                    "\tadd.s64 \t%icd0, %icd0, %icd1;"]
            out += [f"\tst.global.u64 \t[%icd0+{8 * c}], %icn{c};" for c in range(len(CLASSES))]
    return "\n".join(out) + "\n"


class Driver:
    """The CUDA driver API through ctypes, on torch's current context."""

    def __init__(self):
        torch.zeros(1, device="cuda")
        cu = ctypes.CDLL("libcuda.so.1")
        p, u = ctypes.c_void_p, ctypes.c_uint
        cu.cuModuleLoadData.argtypes = [ctypes.POINTER(p), p]
        cu.cuModuleGetFunction.argtypes = [ctypes.POINTER(p), p, ctypes.c_char_p]
        cu.cuLaunchKernel.argtypes = [p, u, u, u, u, u, u, u, p, ctypes.POINTER(p),
                                      ctypes.POINTER(p)]
        for fn in (cu.cuModuleLoadData, cu.cuModuleGetFunction, cu.cuLaunchKernel):
            fn.restype = ctypes.c_int
        self.cu = cu

    @staticmethod
    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    def load(self, cubin):
        mod, image = ctypes.c_void_p(), ctypes.create_string_buffer(cubin)
        self.check(self.cu.cuModuleLoadData(ctypes.byref(mod), ctypes.cast(image, ctypes.c_void_p)),
                   "cuModuleLoadData")
        return mod

    def launch(self, mod, name, n, args):
        """Runs kernel ``name`` on n threads, THREADS a block, with ``args``
        (ctypes values, kept referenced until it has finished)."""
        fn = ctypes.c_void_p()
        self.check(self.cu.cuModuleGetFunction(ctypes.byref(fn), mod, name.encode()),
                   f"cuModuleGetFunction {name}")
        params = (ctypes.c_void_p * len(args))(
            *[ctypes.cast(ctypes.pointer(a), ctypes.c_void_p) for a in args])
        self.check(self.cu.cuLaunchKernel(fn, (n + THREADS - 1) // THREADS, 1, 1, THREADS,
                                          1, 1, 0, None, params, None), f"launch {name}")
        torch.cuda.synchronize()


def arguments(n, seed):
    """(a, b) in float64 for each step: the messages' range (see the
    module's note)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    mags = np.concatenate([10.0 ** rng.uniform(-6, np.log10(300), half),
                           rng.uniform(0, 300, n - half)])
    rng.shuffle(mags)
    other = rng.permutation(mags)
    signs = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return {
        "phi": (mags, other),
        "minstar_approx": (mags, other),
        "minstar_full": (mags, other),
        "tanh_half": (signs * mags, other),
        "atanh2": (signs * np.tanh(mags / 2), other),
    }


def i8_source():
    """The i8 probe kernels: k_i8_<step>(x, z, y, n) stores step(x[i],
    z[i]) at y[i] and z[i] at y[n + i]; k_i8_identity stores x[i] there;
    r_i8_<step>(x, z, y, n) runs a chain of I8_CHAIN_CALLS calls from x[i]
    with z[i] and stores its end at y[i]."""
    lines = ['#include "i8.cuh"', "using namespace ldpc;"]
    probes = {"identity": "a", **{k: expr for k, (_, expr) in I8_STEPS.items()}}
    for step, expr in probes.items():
        lines.append(
            f'extern "C" __global__ void k_i8_{step}(const uint32_t* x, const uint32_t* z, '
            "uint32_t* y, int n) {\n"
            "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "  if (i >= n) return;\n"
            "  const uint32_t a = x[i], b = z[i];\n"
            f"  y[i] = {expr};\n"
            "  y[n + i] = b;\n}")
    for step, chain in I8_CHAIN.items():
        lines.append(
            f'extern "C" __global__ void r_i8_{step}(const uint32_t* x, const uint32_t* z, '
            "uint32_t* y, int n) {\n"
            "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "  if (i >= n) return;\n"
            "  uint32_t a = x[i];\n"
            "  const uint32_t b = z[i];\n"
            "#pragma unroll\n"
            f"  for (int r = 0; r < {I8_CHAIN_CALLS}; ++r) a = {chain};\n"
            "  y[i] = a;\n}")
    return "\n".join(lines) + "\n"


def sass_opcodes(cubin):
    """{kernel: [opcode of each SASS instruction, predicate dropped]} of a
    cubin, the uncounted ones (SASS_SKIPPED) left out."""
    dump = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    kernels, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)):
            op = re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split()[0]
            if op.split(".")[0] not in SASS_SKIPPED:
                kernels[name].append(op)
    return kernels


def sass_class(op):
    """The class of a SASS opcode: "f32" for the FMA pipe's, else "int"."""
    return "f32" if op.split(".")[0] in SASS_FMA else "int"


def count_i8(forms, tmp):
    """{form: {step: {"int": n, "f32": m, "ops": {opcode: count}}}}: the
    SASS instructions each i8 step executes a call (its probe less the
    identity probe), for each form's i8.cuh; also returns each form's
    cubin."""
    out, cubins = {}, {}
    for form, d in forms.items():
        cu, cubin = Path(tmp) / f"i8_{form}.cu", Path(tmp) / f"i8_{form}.cubin"
        cu.write_text(i8_source())
        subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-cubin", "-I", str(d), "-o", str(cubin),
                        str(cu)], check=True)
        kernels = sass_opcodes(cubin)
        base = Counter(kernels["k_i8_identity"])
        out[form] = {}
        for step in I8_STEPS:
            diff = Counter(kernels[f"k_i8_{step}"])
            diff.subtract(base)
            if any(n < 0 for n in diff.values()):
                raise SystemExit(f"{form} {step}: the probe lacks identity instructions "
                                 f"{dict(+(-diff))}")
            ops = {op: n for op, n in sorted(diff.items()) if n}
            counts = Counter()
            for op, n in ops.items():
                counts[sass_class(op)] += n
            out[form][step] = {"int": counts["int"], "f32": counts["f32"], "ops": ops}
        cubins[form] = cubin.read_bytes()
    return out, cubins


def i8_words(n, seed):
    """Two random words a thread, a byte in [0, 127] a frame."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.integers(0, 128, (n, 4), dtype=np.uint8).view(np.int32)[:, 0],
                         device="cuda") for _ in range(2)]


def rate_i8(drv, cubin, n, seed, label):
    """Times each step's chain kernel (r_i8_<step>) on n threads; prints
    words a second."""
    mod = drv.load(cubin)
    a, b = i8_words(n, seed)
    y = torch.empty_like(a)
    args = [ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), ctypes.c_int(n)]
    for step in I8_STEPS:
        ms = []
        for _ in range(6):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            drv.launch(mod, f"r_i8_{step}", n, args)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        med = float(np.median(ms[1:]))
        calls = n * I8_CHAIN_CALLS
        print(f"i8 {label} {step}: {med:.3f} ms for {calls} calls, "
              f"{calls / med / 1e6:.3f} G words/s (a thread a chain of {I8_CHAIN_CALLS}, "
              "median of 5)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", action="store_true", help="also time each probe")
    ap.add_argument("--i8-form", action="append", default=[], metavar="NAME=DIR",
                    help="also count the i8 steps of DIR/i8.cuh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    n = args.n // THREADS * THREADS
    with tempfile.TemporaryDirectory() as tmp:
        cu, ptx = Path(tmp) / "probe.cu", Path(tmp) / "probe.ptx"
        cu.write_text(source())
        subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-ptx", "-I", str(CSRC), "-o", str(ptx),
                        str(cu)], check=True)
        text = plain = ptx.read_text()
        for t, (suffix, _) in TYPES.items():
            for step in STEPS:
                text = instrument(text, f"k_{step}_{suffix}")
        inst, cubin = Path(tmp) / "probe_counted.ptx", Path(tmp) / "probe.cubin"
        inst.write_text(text)
        subprocess.run([_tool("ptxas"), "-arch=sm_90a", "-O3", "-o", str(cubin), str(inst)],
                       check=True)
        image = cubin.read_bytes()
        (Path(tmp) / "plain.ptx").write_text(plain)
        subprocess.run([_tool("ptxas"), "-arch=sm_90a", "-O3", "-o", str(cubin),
                        str(Path(tmp) / "plain.ptx")], check=True)
        plain_image = cubin.read_bytes()
        i8_forms = {"repo": CSRC, **dict(f.split("=", 1) for f in args.i8_form)}
        i8_counts, i8_cubins = count_i8(i8_forms, tmp)
    drv = Driver()
    mod, plain_mod = drv.load(image), drv.load(plain_image)
    args_of = arguments(n, args.seed)
    fewest = {}
    for t, (suffix, _) in TYPES.items():
        dtype = torch.float32 if t == "float" else torch.float64
        ctype = ctypes.c_float if t == "float" else ctypes.c_double
        prod_max = float(np.nextafter(np.array(1, dtype=np.float32 if t == "float" else
                                               np.float64), 0))
        fewest[t] = {}
        for step in STEPS:
            a, b = (torch.tensor(v, dtype=dtype, device="cuda") for v in args_of[step])
            y = torch.empty_like(a)
            counts = torch.zeros((n, len(CLASSES)), dtype=torch.int64, device="cuda")
            drv.launch(mod, f"k_{step}_{suffix}", n, [
                ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
                ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
                ctypes.c_int(n), ctype(CLAMP[t]), ctype(prod_max)])
            assert bool(torch.isfinite(y).all()), f"{step} {t}: non-finite results"
            per = counts.double()
            lo, mean, hi = per.min(0).values, per.mean(0), per.max(0).values
            fewest[t][step] = {c: int(lo[k]) for k, c in enumerate(CLASSES)}
            print(f"{t} {step}: " + ", ".join(
                f"{c} {int(lo[k])}/{mean[k]:.2f}/{int(hi[k])}" for k, c in enumerate(CLASSES))
                + f" (fewest/mean/most over {n} arguments)")
            if args.rate:
                call_args = [ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
                             ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(0),
                             ctypes.c_int(n), ctype(CLAMP[t]), ctype(prod_max)]
                ms = []
                for _ in range(6):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    drv.launch(plain_mod, f"k_{step}_{suffix}", n, call_args)
                    end.record()
                    torch.cuda.synchronize()
                    ms.append(start.elapsed_time(end))
                med = float(np.median(ms[1:]))
                print(f"{t} {step}: {med:.3f} ms for {n} calls, {n / med / 1e6:.3f} G calls/s "
                      "(uninstrumented, a thread a call, median of 5)")
    for form, steps in i8_counts.items():
        for step, c in steps.items():
            ops = ", ".join(f"{op} {n}" for op, n in c["ops"].items())
            print(f"i8 {form} {step}: {c['int']} int + {c['f32']} f32 SASS instructions a "
                  f"word of four frames ({ops})")
        if args.rate:
            rate_i8(drv, i8_cubins[form], n, args.seed, form)
    fewest["i8"] = {step: {"int": c["int"], "f32": c["f32"]}
                    for step, c in i8_counts["repo"].items()}
    print(json.dumps(fewest))


if __name__ == "__main__":
    main()
