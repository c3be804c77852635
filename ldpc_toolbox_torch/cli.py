"""Command-line interface: the ``ber`` subcommand.

``python -m ldpc_toolbox_torch ber CODE ...`` runs the BER sweep of the
reference CLI (cli/ber.rs) on the port, for an alist path (the generic
parity-check decode) and the code specs ``dvbs2:RATE[:short]``,
``5g:BG:Z``, ``ccsds:RATE:K`` (the AR4JA codes) and ``ccsds-c2`` (the
lifted decode), BPSK and all 44 decoder names
of both schedules (``--decoder`` defaults to the reference's ``Phif64``,
which floods; ``HLMinsumbf16`` and ``HLMinstarapproxi8`` are layered; the
i8 names quantize the channel LLRs inside the decode). It prints the
reference's table, one row per Eb/N0 point once
the point ends, and writes the same rows to ``--output-file``: the columns
and formatting of the JAX package's ``ber``, from this module's own copies
of its helpers (``parse_duration``, ``_BER_HEADER``, ``_format_duration``,
``_format_progress``).

A code whose trailing square is singular (``ccsds-c2``, whose H is also
rank-deficient, or a non-systematic alist) is encoded on its full-rank
rows with its columns permuted to a systematic form and decoded in its
own column order (``_systematic_perm_if_needed``, the JAX package's).

Not ported yet (ROADMAP A5, A9, A10): the live progress rows and
checkpoints, puncturing, interleaving, 8PSK, and the other subcommands.
"""

from __future__ import annotations

import argparse
import re
import sys


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


def run_ber(args) -> None:
    from .simulation.factory import BerTestBuilder

    try:
        h, lifted = resolve_ber_code(args.code)
    except (KeyError, ValueError) as e:
        _die(f"invalid code spec {args.code!r}: {e}")
    sys_perm, enc_h, prebuilt_enc = _systematic_perm_if_needed(h, args.device)
    num_ebn0s = int((args.max_ebn0 - args.min_ebn0) / args.step_ebn0) + 1
    ebn0s = [args.min_ebn0 + i * args.step_ebn0 for i in range(num_ebn0s)]
    try:
        test = BerTestBuilder(
            h=h,
            lifted_graph=lifted,
            decoder_implementation=args.decoder,
            max_frame_errors=args.frame_errors,
            min_run_time=parse_duration(args.min_time) if args.min_time else None,
            max_run_time=parse_duration(args.max_time) if args.max_time else None,
            max_iterations=args.max_iter,
            ebn0s_db=ebn0s,
            bch_max_errors=args.bch_max_errors,
            batch_size=args.batch_size,
            seed=args.seed,
            device=args.device,
            systematic_permutation=sys_perm,
            encoder_h=enc_h,
            prebuilt_encoder=prebuilt_enc,
        ).build()
    except (ValueError, NotImplementedError) as e:
        _die(str(e))
    print(_BER_HEADER, flush=True)
    out_file = open(args.output_file, "w") if args.output_file else None
    try:
        if out_file:
            out_file.write(_BER_HEADER + "\n")
        for stats in test.run():
            row = _format_progress(stats, False)
            print(row, flush=True)
            if out_file:
                out_file.write(row + "\n")
    finally:
        if out_file:
            out_file.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ldpc-toolbox-torch",
        description="LDPC toolbox on PyTorch with CUDA kernels for Hopper",
    )
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("ber", help="Performs a BER simulation")
    s.add_argument("code", help=f"code spec: {CODE_SPECS}")
    s.add_argument("--output-file")
    s.add_argument("--decoder", default="Phif64")
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
    s.add_argument("--device", default="cuda",
                   help="torch device that runs the sweep (default cuda)")
    s.set_defaults(func=run_ber)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
