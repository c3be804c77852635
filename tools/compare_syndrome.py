"""The syndrome kernel and the streaming loops' freeze against another copy
of the package (a parent commit's), on one GPU, in turns.

    python3 tools/compare_syndrome.py --parent DIR [--decoder NAME ...]
        [--ebn0 DB ...] [--reps 5]

DIR holds the other copy's ``ldpc_toolbox_torch`` package (for example
``git archive PARENT ldpc_toolbox_torch | tar -x -C DIR --strip-components=1``
into a git-ignored directory). It is imported under another name and builds
its kernels into its own ``build/``; both copies' sources that the named
decoders' streaming paths need are built at once. On the flagship (DVB-S2
R1_2, B = 1024, at most 30 iterations, the LLRs of ``chip_smoke.py``) it
holds the two copies' outputs equal and times them in turns (the other
copy first, the order reversed every round; CUDA events, medians of
``--reps``):

1. a streaming iteration's test and freeze on the ``Minsumbf16`` posterior
   bits after one iteration at the first Eb/N0, with the host read of the
   unconverged count that ends it: each copy's ``fused_syndrome_freeze``,
   or, in a copy from before it, its ``fused_syndrome_bits`` and the torch
   ops of its loop's freeze;
2. the syndrome kernel alone on the same bits and on bits where every
   frame passes (all-zero): each copy's ``fused_syndrome_bits``, and this
   copy's ``fused_syndrome_freeze`` without the host read, a launch timed
   alone and twenty in a row;
3. each decoder's streaming decode (``resident=False``) at each Eb/N0.

Prints the card's name and power limit, a line a comparison, and one JSON
line with every time in milliseconds. The timing in turns is
``compare_forms.turns``, the LLRs ``chip_smoke.py``'s.
"""

import argparse
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from compare_forms import turns  # puts the repository root on the path

import ldpc_toolbox_torch
from chip_smoke import (
    FLAGSHIP_BATCH as BATCH,
    FLAGSHIP_ITERS as ITERS,
    Code,
    R1_2_RATE,
    channel_llrs,
    sigma_at,
)

#: launches timed in a row
ROW = 20
#: the sources a streaming path needs, by its rule family and schedule
SOURCES = {
    ("min-sum", "flooding"): ("flooding",),
    ("min-sum", "layered"): ("flooding", "fused_layered"),
    ("i8", "flooding"): ("flooding", "flooding_i8"),
    ("i8", "layered"): ("flooding", "fused_layered_i8"),
}


def load_package(path, name="other_ldpc_toolbox_torch"):
    """The package at ``path`` imported as ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py", submodule_search_locations=[str(path)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def sources(names):
    """The kernel sources the streaming paths of ``names`` build."""
    out = {"flooding"}
    for name in names:
        layered = name.startswith("HL")
        if name.endswith(("f32", "f64")) and "Minsum" not in name:
            out.add(("fused_layered_" if layered else "flooding_") + name[-3:])
        else:
            family = "i8" if "i8" in name else "min-sum"
            out.update(SOURCES[family, "layered" if layered else "flooding"])
    return sorted(out)


def llrs_at(ebn0):
    """chip_smoke.py's flagship LLRs (R1_2, seed 0) at ``ebn0``."""
    return channel_llrs(Code.R1_2.n, BATCH, sigma_at(R1_2_RATE, ebn0), seed=0)


def submodule(package, name):
    return importlib.import_module(f"{package.__name__}.{name}")


def freeze_step(fused_bp2, layout):
    """A copy's test and freeze of an iteration, ending with the host read
    of the unconverged count: its ``fused_syndrome_freeze`` where it has
    one, else its syndrome kernel and the torch ops of its loop
    (``decoder/compaction.py`` before the fused step: a parent from before
    ``fused_syndrome_freeze``)."""
    if hasattr(fused_bp2, "fused_syndrome_freeze"):
        def step(bits, frozen, conv, iters, it, counter):
            fused_bp2.fused_syndrome_freeze(bits, frozen, conv, iters, it, counter, layout)
            return int(counter)
        return step

    def step(bits, frozen, conv, iters, it, counter):
        tiles, bt = bits.shape[0], bits.shape[-1]
        ok = fused_bp2.fused_syndrome_bits(bits, layout).reshape(-1) == 0
        newly = ok & ~conv
        iters = torch.where(newly, it, iters)
        frozen = torch.where(newly.reshape(tiles, 1, 1, bt), bits, frozen)
        conv = conv | ok
        return int((~conv).sum())
    return step


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--parent", required=True, type=pathlib.Path)
    p.add_argument("--decoder", action="append")
    p.add_argument("--ebn0", type=float, action="append")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    names = args.decoder or ["Minsumbf16", "HLMinsumbf16"]
    ebn0s = args.ebn0 or [1.0]
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    other = load_package(args.parent.resolve())
    copies = {"parent": other, "this": ldpc_toolbox_torch}
    needed = sources(names)
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(copies, pool.map(
            lambda pkg: submodule(pkg, "ops._build").build_all(needed), copies.values())))
    for copy, libs in built.items():
        print(f"{copy}: built {', '.join(needed)} in {max(s for _, s in libs.values()):.1f} s")
    result = {}

    # 1 and 2: one iteration's test and freeze, and the kernel alone
    this_bp2 = submodule(ldpc_toolbox_torch, "ops.fused_bp2")
    other_bp2 = submodule(other, "ops.fused_bp2")
    decoders = {}
    for copy, pkg in copies.items():
        codes, dec_mod = submodule(pkg, "codes.dvbs2"), submodule(pkg, "decoder")
        decoders[copy] = dec_mod.Decoder(codes.Code.R1_2, "Minsumbf16", device="cuda")
    dec = decoders["this"]
    llrs = llrs_at(ebn0s[0])
    tiles_mod = submodule(ldpc_toolbox_torch, "decoder.lifted_flooding")
    q, _, layout, rule = tiles_mod.flooding_tiles(dec.lifted, dec.arithmetic, llrs)
    c2v = this_bp2.fused_check(this_bp2.fused_var(None, q, layout, rule)[0], layout, rule)
    bits = this_bp2.fused_var(c2v, q, layout, rule)[1]
    other_layout = submodule(other, "decoder.lifted_layered").device_layout(
        decoders["parent"].lifted, torch.device("cuda"))
    assert torch.equal(this_bp2.fused_syndrome_bits(bits, layout),
                       other_bp2.fused_syndrome_bits(bits, other_layout))

    def state():
        frames = bits.shape[0] * bits.shape[-1]
        return (torch.empty_like(bits), torch.zeros(frames, dtype=torch.bool, device="cuda"),
                torch.zeros(frames, dtype=torch.int32, device="cuda"),
                torch.zeros(1, dtype=torch.int32, device="cuda"))

    steps = {"parent": freeze_step(other_bp2, other_layout),
             "this": freeze_step(this_bp2, layout)}
    states = {copy: state() for copy in steps}
    assert steps["parent"](bits, *states["parent"][:3], 1, states["parent"][3]) \
        == steps["this"](bits, *states["this"][:3], 1, states["this"][3])
    times = result["step"] = turns(
        {c: lambda c=c: steps[c](bits, *states[c][:3], 1, states[c][3]) for c in steps},
        args.reps)
    print(f"[{card}] a streaming iteration's test and freeze (Minsumbf16 posterior bits, "
          f"{ebn0s[0]} dB, with the host read): parent {times['parent']:.3f} ms, this "
          f"{times['this']:.3f} ms")
    result["kernel"], result["kernel in a row"] = {}, {}
    for label, b in (("posterior", bits), ("passing", torch.zeros_like(bits))):
        frozen, conv, iters, counter = state()
        kernels = {
            "parent fused_syndrome_bits": lambda b=b: other_bp2.fused_syndrome_bits(
                b, other_layout),
            "this fused_syndrome_bits": lambda b=b: this_bp2.fused_syndrome_bits(b, layout),
            "this fused_syndrome_freeze": lambda b=b: this_bp2.fused_syndrome_freeze(
                b, frozen, conv, iters, 1, counter, layout),
        }
        result["kernel"][label] = turns(kernels, 2 * args.reps)
        print(f"[{card}] the syndrome kernel alone on the {label} bits, a launch: " + ", ".join(
            f"{k} {t:.3f} ms" for k, t in result["kernel"][label].items()))
        # launches in a row: the host's part of a launch overlaps the card's
        # work but the first's
        times = turns({k: lambda f=f: [f() for _ in range(ROW)] for k, f in kernels.items()},
                      args.reps)
        result["kernel in a row"][label] = {k: t / ROW for k, t in times.items()}
        print(f"[{card}] the same, {ROW} launches in a row, a launch: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in result["kernel in a row"][label].items()))

    # 3: the streaming decodes
    result["decode"] = {}
    for ebn0 in ebn0s:
        for name in names:
            runs = {}
            for copy, pkg in copies.items():
                dec_mod = submodule(pkg, "decoder")
                code = submodule(pkg, "codes.dvbs2").Code.R1_2
                d = dec_mod.Decoder(code, name, device="cuda")
                decode = dec_mod.lifted_decode_for(d.schedule)
                x = llrs_at(ebn0)
                runs[copy] = (lambda decode=decode, d=d, x=x:
                              decode(d.lifted, d.arithmetic, x, ITERS, resident=False))
            outs = {copy: run() for copy, run in runs.items()}
            for key in ("codeword", "iterations", "success"):
                assert torch.equal(outs["parent"][key], outs["this"][key]), (name, key)
            times = result["decode"][f"{name} {ebn0} dB"] = turns(runs, args.reps)
            its = outs["this"]["iterations"]
            was, now = times["parent"], times["this"]
            print(f"[{card}] {name} streaming at {ebn0} dB ({int(outs['this']['success'].sum())}"
                  f"/{BATCH} converged, {int(its.max())} iterations): parent {was:.3f} ms, "
                  f"this {now:.3f} ms ({100 * (now / was - 1):+.1f} %), outputs equal")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
