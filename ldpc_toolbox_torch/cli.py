"""Command-line interface.

``python -m ldpc_toolbox_torch <subcommand>``: the nine subcommands of the
reference CLI (cli.rs:30-51) but ``selftest``, with the JAX package's
names, flags and output: ``5g``, ``ber``, ``ccsds``, ``ccsds-c2``,
``dvbs2``, ``encode``, ``mackay-neal``, ``peg``, ``systematic``. The
constructions print alists on stdout; ``--girth`` prints as the reference
does (ccsds, dvbs2, 5g: the girth alone on stdout, "Code girth = N" or
"Code girth is infinite"; peg: the alist, then the girth on stderr).
``encode`` runs its batch encode on ``--device`` (default cuda).

``ber`` runs the BER sweep of the reference CLI (cli/ber.rs) on the port,
for an alist path (the generic parity-check decode) and the code specs
``dvbs2:RATE[:short]``, ``5g:BG:Z``, ``ccsds:RATE:K`` (the AR4JA codes)
and ``ccsds-c2`` (the lifted decode), BPSK or 8PSK (``--modulation``),
with ``--puncturing``, ``--interleaving`` (negative: rows read backwards)
and all 44 decoder names of both schedules (``--decoder`` defaults to the
reference's ``Phif64``, which floods; ``HLMinsumbf16`` and
``HLMinstarapproxi8`` are layered; the i8 names quantize the channel LLRs
inside the decode). It prints the reference's live table, the current
point's row rewritten in place as frames come in (cli/ber.rs:315-340),
writes each point's final row to ``--output-file`` (and, with
``--bch-max-errors``, the LDPC decoder's own row to ``--output-file-ldpc``),
keeps a resumable ``--checkpoint``, and on Ctrl-C exits 130 after saving
it. ``--num-threads`` is accepted and ignored: the analog of the
reference's worker pool is the decode batch, ``--batch-size``.

A code whose trailing square is singular (``ccsds-c2``, whose H is also
rank-deficient, or a non-systematic alist) is encoded on its full-rank
rows with its columns permuted to a systematic form and decoded in its
own column order (``_systematic_perm_if_needed``, the JAX package's).
The helpers are this module's own copies of the JAX package's.

Not ported yet (ROADMAP A10): ``selftest``.
"""

from __future__ import annotations

import argparse
import re
import sys


def parse_puncturing_pattern(s: str) -> list[bool]:
    """Parse "1,1,1,0" (cli/ber.rs:219-229)."""
    out = []
    for a in s.split(","):
        if a == "0":
            out.append(False)
        elif a == "1":
            out.append(True)
        else:
            raise ValueError("invalid puncturing pattern")
    return out


def parse_duration(s: str) -> float:
    """Parse humantime-style durations: "30s", "5m", "1h 30m"; a bare
    number is seconds (framework extension — humantime requires a unit).
    Strict like humantime: unknown units and trailing junk are errors."""
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    units = {
        "ms": 1e-3, "s": 1.0, "sec": 1.0, "secs": 1.0, "m": 60.0,
        "min": 60.0, "mins": 60.0, "h": 3600.0, "hr": 3600.0,
        "hours": 3600.0, "hour": 3600.0, "d": 86400.0, "day": 86400.0,
        "days": 86400.0,
    }
    total = 0.0
    pos = 0
    pattern = re.compile(r"\s*([0-9]+(?:\.[0-9]+)?)\s*([a-z]*)\s*")
    while pos < len(s):
        m = pattern.match(s, pos)
        if m is None or m.start(1) != pos and not s[pos:m.start(1)].isspace():
            raise ValueError(f"cannot parse duration {s!r}")
        num, unit = m.group(1), m.group(2)
        if unit == "":
            # bare seconds allowed only as the entire input
            if pos != 0 or m.end() != len(s):
                raise ValueError(f"cannot parse duration {s!r}")
            total += float(num)
        elif unit in units:
            total += float(num) * units[unit]
        else:
            raise ValueError(f"unknown duration unit {unit!r}")
        pos = m.end()
    return total


_BER_HEADER = (
    "  Eb/N0 |   Frames | Bit errs | Frame er | False de |     BER |"
    "     FER | Avg iter | Avg corr | Throughp | Elapsed\n"
    "--------|----------|----------|----------|----------|---------|"
    "---------|----------|----------|----------|----------"
)


def _format_duration(seconds: float) -> str:
    """Whole-second humantime-like rendering ("1m 5s")."""
    s = int(seconds)
    if s == 0:
        return "0s"
    parts = []
    for unit, size in (("d", 86400), ("h", 3600), ("m", 60), ("s", 1)):
        if s >= size:
            parts.append(f"{s // size}{unit}")
            s %= size
    return " ".join(parts)


def _format_progress(stats, force_ldpc: bool) -> str:
    code_stats = stats.ldpc if (force_ldpc or stats.bch is None) else stats.bch
    return (
        f"{stats.ebn0_db:7.2f} | {stats.num_frames:8} | "
        f"{code_stats.bit_errors:8} | {code_stats.frame_errors:8} | "
        f"{stats.false_decodes:8} | {code_stats.ber:7.2e} | "
        f"{code_stats.fer:7.2e} | {stats.average_iterations:8.1f} | "
        f"{code_stats.average_iterations_correct:8.1f} | "
        f"{stats.throughput_mbps:8.3f} | "
        f"{_format_duration(stats.elapsed)}"
    )


def _die(msg: str):
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(1)


#: the code specs of the ``ber`` positional
CODE_SPECS = ("an alist path, dvbs2:RATE[:short], 5g:BG:Z, ccsds:RATE:K (RATE 1/2, 2/3 or "
              "4/5; K 1024, 4096 or 16384) or ccsds-c2")


def resolve_ber_code(spec: str):
    """An alist path -> (h, None): the generic decode; exits with the JAX
    package's "cannot read alist" message when it cannot be read.
    ``dvbs2:RATE[:short]``, ``5g:BG:Z``, ``ccsds:RATE:K`` or ``ccsds-c2``
    -> (h, LiftedGraph)."""
    import os

    from .decoder.lifted import LiftedGraph, lifted_graph_for, nr5g_maps
    from .sparse import SparseMatrix

    if os.path.exists(spec) or ":" not in spec and spec != "ccsds-c2":
        try:
            return SparseMatrix.from_alist_file(spec), None
        except (FileNotFoundError, ValueError) as e:
            _die(f"cannot read alist {spec!r}: {e}")
    if spec == "ccsds-c2":
        from .codes.ccsds import C2Code

        code = C2Code()
        return code.h(), lifted_graph_for(code)
    parts = spec.split(":")
    if parts[0] == "dvbs2" and len(parts) in (2, 3):
        from .codes.dvbs2 import Code

        name = "R" + parts[1].replace("/", "_")
        if len(parts) == 3:
            if parts[2] != "short":
                raise ValueError(f"unknown DVB-S2 frame size {parts[2]!r}")
            name += "short"
        code = Code[name]
        return code.h(), lifted_graph_for(code)
    if parts[0] == "5g" and len(parts) == 3:
        from .codes.nr5g import BaseGraph

        bg = {"1": BaseGraph.BG1, "2": BaseGraph.BG2}[parts[1]]
        h = bg.h(int(parts[2]))
        return h, LiftedGraph.from_sparse(h, *nr5g_maps(bg, int(parts[2])))
    if parts[0] == "ccsds" and len(parts) == 3:
        from .codes.ccsds import AR4JACode, AR4JAInfoSize, AR4JARate

        rate = {"1/2": AR4JARate.R1_2, "2/3": AR4JARate.R2_3,
                "4/5": AR4JARate.R4_5}[parts[1]]
        size = {1024: AR4JAInfoSize.K1024, 4096: AR4JAInfoSize.K4096,
                16384: AR4JAInfoSize.K16384}[int(parts[2])]
        code = AR4JACode(rate, size)
        return code.h(), lifted_graph_for(code)
    raise ValueError(f"expected {CODE_SPECS}")


def _systematic_perm_if_needed(h, device):
    """(perm, encoder_h, encoder): (None, None, the Encoder of h on
    ``device``) when h's trailing square is invertible, else (perm, h_enc,
    None) with h_enc the full-rank rows of h (None when h is already full
    rank) and perm their systematic column permutation; BerTest then
    encodes on h_enc[:, perm] and decodes in h's column order with every
    redundant check (CCSDS C2: 1022 rows of rank 1020, the (8176, 7156)
    code)."""
    from .encoder import Encoder, EncoderError
    from .systematic import SystematicError, full_rank_rows, systematic_permutation

    try:
        return None, None, Encoder(h, device=device)
    except EncoderError:
        pass
    h_enc = full_rank_rows(h)
    try:
        perm = systematic_permutation(h_enc)
    except SystematicError as e:
        _die(str(e))
    return perm, (None if h_enc is h else h_enc), None


def _print_alist_or_girth(h, girth: bool, alist_newline: bool = False) -> None:
    """The standards subcommands' output: with ``--girth`` only the girth,
    on stdout ("Code girth = N" / "Code girth is infinite",
    cli/ccsds.rs:63-68, cli/dvbs2.rs:84-89, cli/nr5g.rs:39-46); else the
    alist, with ``println!``'s extra newline (5g) or without (ccsds,
    dvbs2)."""
    if girth:
        g = h.girth()
        if g is None:
            print("Code girth is infinite")
        else:
            print(f"Code girth = {g}")
    else:
        sys.stdout.write(h.alist() + ("\n" if alist_newline else ""))


# -- the host subcommands ------------------------------------------------------


def run_5g(args) -> None:
    from .codes.nr5g import LIFTING_SIZES, BaseGraph

    bg = BaseGraph.BG1 if args.base_graph == "1" else BaseGraph.BG2
    if args.lifting_size not in LIFTING_SIZES:
        # the reference validates Z as a clap ValueEnum (nr5g.rs:78-232)
        _die(
            f"invalid lifting size {args.lifting_size} "
            f"(valid: {', '.join(str(z) for z in sorted(LIFTING_SIZES))})"
        )
    _print_alist_or_girth(bg.h(args.lifting_size), args.girth, alist_newline=True)


def run_ccsds(args) -> None:
    from .codes.ccsds import AR4JACode, AR4JAInfoSize, AR4JARate

    rates = {"1/2": AR4JARate.R1_2, "2/3": AR4JARate.R2_3, "4/5": AR4JARate.R4_5}
    sizes = {
        1024: AR4JAInfoSize.K1024,
        4096: AR4JAInfoSize.K4096,
        16384: AR4JAInfoSize.K16384,
    }
    if args.rate not in rates:
        _die(f"invalid rate {args.rate}")
    if args.block_size not in sizes:
        _die(f"invalid block size {args.block_size}")
    h = AR4JACode(rates[args.rate], sizes[args.block_size]).h()
    _print_alist_or_girth(h, args.girth)


def run_ccsds_c2(args) -> None:
    from .codes.ccsds import C2Code

    sys.stdout.write(C2Code().h().alist())


def run_dvbs2(args) -> None:
    from .codes.dvbs2 import Code

    name = "R" + args.rate.replace("/", "_") + ("short" if args.short else "")
    try:
        code = Code[name]
    except KeyError:
        frame = "short" if args.short else "normal"
        _die(f"Invalid rate {args.rate} for {frame} FECFRAME")
    _print_alist_or_girth(code.h(), args.girth)


def run_mackay_neal(args) -> None:
    from .mackay_neal import Config, FillPolicy, MacKayNealError

    conf = Config(
        nrows=args.num_rows,
        ncols=args.num_columns,
        wr=args.wr,
        wc=args.wc,
        backtrack_cols=args.backtrack_cols,
        backtrack_trials=args.backtrack_trials,
        min_girth=args.min_girth,
        girth_trials=args.girth_trials,
        fill_policy=FillPolicy.UNIFORM if args.uniform else FillPolicy.RANDOM,
    )
    if args.search:
        found = conf.search(args.seed, args.seed_trials)
        if found is None:
            _die("no solution found")  # cli/mackay_neal.rs:105
        seed, h = found
        print(f"seed = {seed}", file=sys.stderr)
    else:
        try:
            h = conf.run(args.seed)
        except MacKayNealError as e:
            _die(str(e))
    print(h.alist())  # println! (cli/mackay_neal.rs:111)


def run_peg(args) -> None:
    from .peg import Config, PegError

    conf = Config(nrows=args.num_rows, ncols=args.num_columns, wc=args.wc)
    try:
        h = conf.run(args.seed)
    except PegError as e:
        _die(str(e))
    for r in range(h.num_rows):
        if h.row_weight(r) < 2:
            # the reference's wording, its Unicode signs too (cli/peg.rs:56-64)
            msg = "warning: at least 1 row weight ≤ 1"
            if conf.wc < 3:
                msg += " (try col weight ≥ 3?)"
            print(msg, file=sys.stderr)
            break
    print(h.alist())  # println! (cli/peg.rs:66)
    if args.girth:
        # peg gives the girth on stderr, with the long infinity wording
        # (cli/peg.rs:67-71)
        g = h.girth()
        if g is None:
            print("Code girth = infinity (there are no cycles)", file=sys.stderr)
        else:
            print(f"Code girth = {g}", file=sys.stderr)


def run_systematic(args) -> None:
    from .sparse import SparseMatrix
    from .systematic import SystematicError, parity_to_systematic

    h = SparseMatrix.from_alist_file(args.alist)
    try:
        hs = parity_to_systematic(h)
    except SystematicError as e:
        _die(str(e))
    print(hs.alist())  # println! (cli/systematic.rs:24)


def run_encode(args) -> None:
    import numpy as np
    import torch

    from .encoder import Encoder, EncoderError
    from .simulation.puncturing import Puncturer
    from .sparse import SparseMatrix

    h = SparseMatrix.from_alist_file(args.alist)
    try:
        encoder = Encoder(h, device=args.device)
    except EncoderError as e:
        _die(str(e))
    puncturer = (
        Puncturer(parse_puncturing_pattern(args.puncturing))
        if args.puncturing
        else None
    )
    k = encoder.k
    # constant memory, like the reference's read_exact loop
    # (cli/encode.rs:34-71): read a bounded chunk of frames, batch-encode
    # it on the device, write, repeat; a trailing partial word is ignored
    chunk_frames = max(1, (1 << 22) // k)
    with open(args.input, "rb") as inp, open(args.output, "wb") as out:
        pending = b""
        while True:
            buf = inp.read(chunk_frames * k - len(pending))
            data = pending + buf
            nwords = len(data) // k
            pending = data[nwords * k :]
            if nwords == 0:
                if not buf:
                    return
                continue
            msgs = np.frombuffer(data[: nwords * k], np.uint8).reshape(nwords, k)
            cw = encoder.encode_batch(torch.from_numpy(msgs.copy()).to(args.device))
            if puncturer is not None:
                cw = puncturer.puncture(cw)
            out.write(cw.cpu().numpy().astype(np.uint8).tobytes())
            if not buf:
                return


# -- ber -----------------------------------------------------------------------


def _live_reporter(out_file, out_file_ldpc):
    """The ``ber`` reporter: the current point's row on stdout, rewritten
    in place while the point runs (cli/ber.rs:315-340); each point's final
    row also to the result files."""
    state = {"last_ebn0": None, "printed": False}

    def reporter(stats, final):
        if state["printed"] and state["last_ebn0"] == stats.ebn0_db:
            sys.stdout.write("\x1b[1A\x1b[2K")  # rewrite the row in place
        sys.stdout.write(_format_progress(stats, False) + "\n")
        sys.stdout.flush()
        state["last_ebn0"] = stats.ebn0_db
        state["printed"] = True
        if final:
            if out_file:
                out_file.write(_format_progress(stats, False) + "\n")
                out_file.flush()
            if out_file_ldpc:
                out_file_ldpc.write(_format_progress(stats, True) + "\n")
                out_file_ldpc.flush()

    return reporter


def run_ber(args) -> None:
    from .simulation.factory import BerTestBuilder, Modulation

    try:
        puncturing = (
            parse_puncturing_pattern(args.puncturing) if args.puncturing else None
        )
    except ValueError as e:
        _die(str(e))
    try:
        h, lifted = resolve_ber_code(args.code)
    except (KeyError, ValueError) as e:
        _die(f"invalid code spec {args.code!r}: {e}")
    sys_perm, enc_h, prebuilt_enc = _systematic_perm_if_needed(h, args.device)
    num_ebn0s = int((args.max_ebn0 - args.min_ebn0) / args.step_ebn0) + 1
    ebn0s = [args.min_ebn0 + i * args.step_ebn0 for i in range(num_ebn0s)]
    out_file = open(args.output_file, "w") if args.output_file else None
    out_file_ldpc = (
        open(args.output_file_ldpc, "w")
        if (args.output_file_ldpc and args.bch_max_errors > 0)
        else None
    )
    try:
        try:
            test = BerTestBuilder(
                h=h,
                lifted_graph=lifted,
                modulation=Modulation.parse(args.modulation),
                decoder_implementation=args.decoder,
                puncturing_pattern=puncturing,
                interleaving_columns=args.interleaving,
                max_frame_errors=args.frame_errors,
                min_run_time=parse_duration(args.min_time) if args.min_time else None,
                max_run_time=parse_duration(args.max_time) if args.max_time else None,
                max_iterations=args.max_iter,
                ebn0s_db=ebn0s,
                reporter=_live_reporter(out_file, out_file_ldpc),
                bch_max_errors=args.bch_max_errors,
                batch_size=args.batch_size,
                seed=args.seed,
                device=args.device,
                checkpoint_path=args.checkpoint,
                systematic_permutation=sys_perm,
                encoder_h=enc_h,
                prebuilt_encoder=prebuilt_enc,
            ).build()
        except (ValueError, NotImplementedError) as e:
            _die(str(e))
        print(_BER_HEADER, flush=True)
        for f in (out_file, out_file_ldpc):
            if f:
                f.write(_BER_HEADER + "\n")
        test.run()
    except KeyboardInterrupt:
        # the reference traps Ctrl-C to restore the terminal (cli/ber.rs:
        # 254-261); the sweep has saved its checkpoint before unwinding
        sys.stdout.write("\n")
        msg = "interrupted"
        if args.checkpoint:
            msg += f"; resume with --checkpoint {args.checkpoint}"
        print(msg, file=sys.stderr)
        sys.exit(130)
    finally:
        for f in (out_file, out_file_ldpc):
            if f:
                f.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ldpc-toolbox-torch",
        description="LDPC toolbox on PyTorch with CUDA kernels for Hopper",
    )
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("5g", help="Generates the alist of 5G NR LDPCs")
    s.add_argument("--base-graph", required=True, choices=["1", "2"])
    s.add_argument("--lifting-size", required=True, type=int)
    s.add_argument("--girth", action="store_true")
    s.set_defaults(func=run_5g)

    s = sub.add_parser("ber", help="Performs a BER simulation")
    s.add_argument("code", help=f"code spec: {CODE_SPECS}")
    s.add_argument("--output-file")
    s.add_argument("--output-file-ldpc",
                   help="the LDPC decoder's own rows (with --bch-max-errors)")
    s.add_argument("--decoder", default="Phif64")
    s.add_argument("--modulation", default="BPSK", choices=["BPSK", "8PSK"])
    s.add_argument("--puncturing", help='puncturing pattern, e.g. "1,1,1,0"')
    s.add_argument("--interleaving", type=int,
                   help="interleaver columns (negative: read rows backwards)")
    s.add_argument("--min-ebn0", type=float, required=True)
    s.add_argument("--max-ebn0", type=float, required=True)
    s.add_argument("--step-ebn0", type=float, required=True)
    s.add_argument("--max-iter", type=int, default=100)
    s.add_argument("--frame-errors", type=int, default=100)
    s.add_argument("--min-time")
    s.add_argument("--max-time")
    s.add_argument("--bch-max-errors", type=int, default=0)
    s.add_argument("--batch-size", type=int, default=128)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--num-threads", type=int, default=None,
                   help="accepted for reference-CLI compatibility (ignored)")
    s.add_argument("--checkpoint", help="sweep checkpoint file (resumable)")
    s.add_argument("--device", default="cuda",
                   help="torch device that runs the sweep (default cuda)")
    s.set_defaults(func=run_ber)

    s = sub.add_parser("ccsds", help="Generates the alist of CCSDS LDPCs")
    s.add_argument("-r", "--rate", required=True)
    s.add_argument("--block-size", type=int, required=True)
    s.add_argument("--girth", action="store_true")
    s.set_defaults(func=run_ccsds)

    s = sub.add_parser("ccsds-c2", help="Generates the alist of CCSDS C2 LDPC")
    s.set_defaults(func=run_ccsds_c2)

    s = sub.add_parser("dvbs2", help="Generates the alist of DVB-S2 LDPCs")
    s.add_argument("-r", "--rate", required=True)
    s.add_argument("--short", action="store_true")
    s.add_argument("--girth", action="store_true")
    s.set_defaults(func=run_dvbs2)

    s = sub.add_parser("encode", help="Encodes a file of unpacked bits")
    s.add_argument("alist")
    s.add_argument("input")
    s.add_argument("output")
    s.add_argument("puncturing", nargs="?")
    s.add_argument("--device", default="cuda",
                   help="torch device that encodes (default cuda)")
    s.set_defaults(func=run_encode)

    s = sub.add_parser("mackay-neal", help="Generates a MacKay-Neal LDPC")
    s.add_argument("num_rows", type=int)
    s.add_argument("num_columns", type=int)
    s.add_argument("wr", type=int)
    s.add_argument("wc", type=int)
    s.add_argument("seed", type=int)
    s.add_argument("--backtrack-cols", type=int, default=0)
    s.add_argument("--backtrack-trials", type=int, default=0)
    s.add_argument("--min-girth", type=int)
    s.add_argument("--girth-trials", type=int, default=0)
    s.add_argument("--uniform", action="store_true")
    s.add_argument("--seed-trials", type=int, default=1000)
    s.add_argument("--search", action="store_true")
    s.set_defaults(func=run_mackay_neal)

    s = sub.add_parser("peg", help="Generates an LDPC with Progressive Edge Growth")
    s.add_argument("num_rows", type=int)
    s.add_argument("num_columns", type=int)
    s.add_argument("wc", type=int)
    s.add_argument("seed", type=int)
    s.add_argument("--girth", action="store_true")
    s.set_defaults(func=run_peg)

    s = sub.add_parser(
        "systematic",
        help="Permutes the columns of an alist to make the code systematic",
    )
    s.add_argument("alist")
    s.set_defaults(func=run_systematic)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
