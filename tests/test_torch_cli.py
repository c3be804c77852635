"""The port's command line. ``ber`` on the code specs: ``ccsds:RATE:K``
resolves to the JAX package's parity-check matrix and lifted graph and
runs a sweep on the CPU; so do ``ccsds-c2`` (through the encode-side
permutation) and an alist path (the generic decode), which exits as the
JAX package's ``ber`` does when it cannot be read. ``ber``'s puncturing,
8PSK, interleaving, checkpoint, live reporter, ``--output-file-ldpc`` and
Ctrl-C; and every host subcommand (``5g``, ``ccsds``, ``ccsds-c2``,
``dvbs2``, ``mackay-neal``, ``peg``, ``systematic``, ``encode``), whose
stdout, stderr and exit code equal the JAX CLI's byte for byte."""

import contextlib
import io
import json
import math

import numpy as np
import pytest
import torch

from ldpc_toolbox_tpu import cli as jax_cli
from ldpc_toolbox_torch import cli
from ldpc_toolbox_torch.simulation import ber as torch_ber

# The tests run many small ops on small tensors; one intra-op thread per
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

#: a 2 x 4 alist whose two rows are equal (rank 1, its trailing square
#: singular)
TINY_ALIST = "4 2\n2 4\n1 1 1 1\n2 2\n1 2\n1 2\n1 2\n1 2\n1 2 3 4\n1 2 3 4\n"


@pytest.mark.parametrize("spec", ["ccsds:1/2:1024", "ccsds:2/3:1024", "ccsds:4/5:1024",
                                  "ccsds:1/2:4096"])
def test_ccsds_spec_matches_jax(spec):
    h, lg = cli.resolve_ber_code(spec)
    jh, jlg = jax_cli._resolve_ber_code(spec)
    assert (h.num_rows, h.num_cols) == (jh.num_rows, jh.num_cols)
    for r in range(jh.num_rows):
        assert h.row_list(r) == jh.row_list(r), r
    assert (lg.n, lg.Z, lg.num_var_groups) == (jlg.n, jlg.Z, jlg.num_var_groups)
    np.testing.assert_array_equal(lg.var_cols, jlg.var_cols)


def test_cli_ber_runs_ccsds(capsys, tmp_path):
    """AR4JA K=1024 rate 1/2 through ``ber --device cpu``: the port's dense
    encoder takes its H as it is (punctured columns are sent, as without
    the reference's --puncturing), two Eb/N0 points of a few frames."""
    out = tmp_path / "ber.txt"
    cli.main(["ber", "ccsds:1/2:1024", "--device", "cpu", "--decoder", "HLMinsumbf16",
              "--min-ebn0", "0", "--max-ebn0", "4", "--step-ebn0", "4", "--max-iter", "10",
              "--frame-errors", "4", "--max-time", "2s", "--batch-size", "16",
              "--output-file", str(out)])
    rows = out.read_text().splitlines()[2:]
    assert [r.split("|")[0].strip() for r in rows] == ["0.00", "4.00"]
    low, high = (r.split("|") for r in rows)
    assert int(low[3]) >= 4  # frame errors at 0 dB
    assert int(high[3]) == 0 and int(high[1]) >= 16  # none at 4 dB
    assert "Eb/N0" in capsys.readouterr().out


def _rows(text):
    """The result rows of a ``ber`` table (after the header's two lines; a
    row the JAX package's live reporter rewrote counts once, its last)."""
    rows = []
    for line in text.splitlines():
        if "\x1b[1A" in line:  # the cursor moved up: the last row is rewritten
            rows.pop()
            line = line.split("\x1b[2K")[-1]
        if "|" in line and "Eb/N0" not in line and not line.startswith("--"):
            rows.append(line.split("|"))
    return rows


def test_cli_ber_runs_ccsds_c2(capsys):
    """``ber ccsds-c2`` on the CPU: C2's H (1022 rows of rank 1020, its
    trailing square singular) is encoded on its full-rank rows through the
    systematic permutation and decoded by the lifted layered decode; at
    4.2 dB no frame fails (the JAX package's RESULTS row: FER 1.1e-4)."""
    cli.main(["ber", "ccsds-c2", "--device", "cpu", "--decoder", "HLMinsumbf16",
              "--min-ebn0", "4.2", "--max-ebn0", "4.2", "--step-ebn0", "1", "--max-iter", "20",
              "--frame-errors", "1", "--max-time", "1s", "--batch-size", "16"])
    (row,) = _rows(capsys.readouterr().out)
    assert row[0].strip() == "4.20" and int(row[1]) >= 16 and int(row[3]) == 0


def test_cli_ber_alist_runs_as_jax_does(capsys, tmp_path):
    """An alist of rank 1 with equal rows runs in both packages (the
    encode-side permutation on its one full-rank row, k = 3, the generic
    decode with both checks), one point each from seed 0, and the two
    frame error rates agree (two-proportion |z| <= 3.29)."""
    path = tmp_path / "h.alist"
    path.write_text(TINY_ALIST)
    args = ["ber", str(path), "--min-ebn0", "1", "--max-ebn0", "1", "--step-ebn0", "1",
            "--frame-errors", "20", "--batch-size", "128"]
    jax_cli.main(args)
    (jrow,) = _rows(capsys.readouterr().out)
    cli.main(args + ["--device", "cpu"])
    (row,) = _rows(capsys.readouterr().out)
    assert jrow[0].strip() == row[0].strip() == "1.00"
    (jn, je), (n, e) = ((int(r[1]), int(r[3])) for r in (jrow, row))
    assert je >= 20 and e >= 20
    p = (je + e) / (jn + n)
    z = (je / jn - e / n) / math.sqrt(p * (1 - p) * (1 / jn + 1 / n))
    assert abs(z) <= 3.29, (jrow, row)


def test_cli_ber_missing_alist_exits_as_jax_does(capsys):
    """A spec that is no file and no code exits 1 with the JAX package's
    "cannot read alist" message."""
    messages = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as exit_:
            main(["ber", "mackay_96.33.964", "--min-ebn0", "1", "--max-ebn0", "1",
                  "--step-ebn0", "1"])
        assert exit_.value.code == 1
        messages.append(capsys.readouterr().err)
    assert messages[0] == messages[1]
    assert messages[1].startswith("error: cannot read alist 'mackay_96.33.964'")


def test_code_help_names_the_specs():
    action = next(a for a in cli.build_parser()._subparsers._group_actions[0]
                  .choices["ber"]._actions if a.dest == "code")
    for spec in ("alist", "dvbs2:RATE[:short]", "5g:BG:Z", "ccsds:RATE:K",
                 "1024, 4096 or 16384", "ccsds-c2"):
        assert spec in action.help


def test_parse_puncturing_pattern_matches_jax():
    for text in ("1,1,1,0", "1,1,1,1,1,1,1,1,1,1,0", "0,1"):
        assert cli.parse_puncturing_pattern(text) == jax_cli.parse_puncturing_pattern(text)
    for text in ("1,2", "", "1,,0"):
        with pytest.raises(ValueError, match="invalid puncturing pattern"):
            cli.parse_puncturing_pattern(text)


def _run(main, args):
    """(stdout, stderr, exit code) of one CLI run in this process."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            main(args)
        except SystemExit as e:
            code = e.code
    return out.getvalue(), err.getvalue(), code


#: an alist whose trailing square is singular and not full rank: the
#: ``systematic`` and ``encode`` error paths
SINGULAR = "4 2\n2 4\n1 1 1 1\n2 2\n1 2\n1 2\n1 2\n1 2\n1 2 3 4\n1 2 3 4\n"

#: host subcommand runs, each compared byte for byte with the JAX CLI's
HOST_RUNS = {
    "5g": ["5g", "--base-graph", "2", "--lifting-size", "8"],
    "5g-girth": ["5g", "--base-graph", "1", "--lifting-size", "4", "--girth"],
    "5g-bad-z": ["5g", "--base-graph", "1", "--lifting-size", "100"],
    "ccsds": ["ccsds", "--rate", "1/2", "--block-size", "1024"],
    "ccsds-girth": ["ccsds", "-r", "4/5", "--block-size", "1024", "--girth"],
    "ccsds-bad-rate": ["ccsds", "--rate", "3/4", "--block-size", "1024"],
    "ccsds-bad-size": ["ccsds", "--rate", "1/2", "--block-size", "2048"],
    "ccsds-c2": ["ccsds-c2"],
    "dvbs2": ["dvbs2", "--rate", "2/3", "--short"],
    "dvbs2-girth": ["dvbs2", "--rate", "1/2", "--short", "--girth"],
    "dvbs2-bad-rate": ["dvbs2", "--rate", "9/10", "--short"],
    "mackay-neal": ["mackay-neal", "8", "16", "6", "3", "42", "--uniform"],
    "mackay-neal-random": ["mackay-neal", "4", "8", "4", "2", "187"],
    "mackay-neal-girth": ["mackay-neal", "64", "128", "6", "3", "2", "--min-girth", "6",
                          "--girth-trials", "10000", "--backtrack-cols", "3",
                          "--backtrack-trials", "200", "--uniform"],
    "mackay-neal-fails": ["mackay-neal", "4", "16", "2", "3", "0"],
    # seeds 18 to 23 in the process pool; only 21 succeeds
    "mackay-neal-search": ["mackay-neal", "8", "16", "4", "2", "18", "--uniform",
                           "--min-girth", "6", "--search", "--seed-trials", "6"],
    "mackay-neal-search-none": ["mackay-neal", "8", "16", "4", "2", "0", "--uniform",
                                "--min-girth", "6", "--search", "--seed-trials", "3"],
    "peg": ["peg", "32", "64", "3", "0"],
    "peg-girth": ["peg", "8", "16", "3", "1", "--girth"],
    "peg-no-cycles": ["peg", "4", "8", "1", "0", "--girth"],
    "peg-warning-hint": ["peg", "10", "4", "1", "0"],
    "peg-warning": ["peg", "20", "6", "3", "0"],
}


@pytest.mark.parametrize("run", list(HOST_RUNS))
def test_host_subcommand_matches_jax(run):
    args = HOST_RUNS[run]
    out, err, code = _run(cli.main, args)
    assert (out, err, code) == _run(jax_cli.main, args)
    if run.endswith(("bad-z", "bad-rate", "bad-size", "fails", "none")):
        assert code == 1 and err.startswith("error: ") and not out
    else:
        assert code == 0 and out


def test_systematic_matches_jax(tmp_path):
    alist = tmp_path / "h.alist"
    alist.write_text(_run(cli.main, ["mackay-neal", "8", "16", "6", "3", "42", "--uniform"])[0])
    singular = tmp_path / "singular.alist"
    singular.write_text(SINGULAR)
    for path, code in ((alist, 0), (singular, 1)):
        result = _run(cli.main, ["systematic", str(path)])
        assert result == _run(jax_cli.main, ["systematic", str(path)])
        assert result[2] == code


@pytest.mark.parametrize("puncturing", [None, "1,1,0,1"])
def test_encode_matches_jax(tmp_path, puncturing):
    """``encode`` on ``--device cpu`` writes the JAX CLI's bytes: whole
    words of the input encoded (a trailing partial word ignored), the
    punctured blocks dropped; a code it cannot encode exits as the JAX
    CLI does."""
    mn = tmp_path / "mn.alist"
    mn.write_text(_run(cli.main, ["mackay-neal", "8", "16", "6", "3", "42", "--uniform"])[0])
    alist = tmp_path / "h.alist"
    alist.write_text(_run(cli.main, ["systematic", str(mn)])[0])
    k = 8
    bits = np.random.default_rng(2).integers(0, 2, 5 * k + 3).astype(np.uint8)
    src = tmp_path / "msg.bin"
    src.write_bytes(bits.tobytes())
    outputs = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        dst = tmp_path / f"cw{len(outputs)}.bin"
        args = ["encode", str(alist), str(src), str(dst)] + ([puncturing] if puncturing else [])
        assert _run(main, args + extra) == ("", "", 0)
        outputs.append(dst.read_bytes())
    assert outputs[0] == outputs[1]
    assert len(outputs[1]) == 5 * (12 if puncturing else 16)
    singular = tmp_path / "singular.alist"
    singular.write_text(SINGULAR)
    args = ["encode", str(singular), str(src), str(tmp_path / "x.bin")]
    result = _run(cli.main, args + ["--device", "cpu"])
    assert result == _run(jax_cli.main, args) and result[2] == 1


def test_cli_ber_punctured_ar4ja_with_checkpoint(tmp_path):
    """The reference CLI's example sweep, punctured AR4JA r=1/2 k=1024
    (puncturing 1,1,1,1,0), on ``--device cpu`` with a checkpoint and
    ``--num-threads`` (ignored): the rows reach the output file, the
    checkpoint holds the finished points, and a second run with it decodes
    no frame and, as the JAX CLI does, prints no row again."""
    out = tmp_path / "ber.txt"
    ckpt = tmp_path / "sweep.json"
    args = ["ber", "ccsds:1/2:1024", "--device", "cpu", "--decoder", "HLMinsumbf16",
            "--puncturing", "1,1,1,1,0", "--min-ebn0", "1.0", "--max-ebn0", "2.5",
            "--step-ebn0", "1.5", "--max-iter", "10", "--frame-errors", "8",
            "--max-time", "3s", "--batch-size", "32", "--num-threads", "4",
            "--checkpoint", str(ckpt), "--output-file", str(out)]
    first, err, code = _run(cli.main, args)
    assert code == 0 and err == ""
    rows = _rows(first)
    assert [r[0].strip() for r in rows] == ["1.00", "2.50"]
    assert int(rows[0][3]) >= 8 and int(rows[1][3]) < int(rows[1][1]) // 4
    assert [r.split("|") for r in out.read_text().splitlines()[2:]] == rows
    state = json.loads(ckpt.read_text())
    assert state["point"] == 2 and len(state["completed"]) == 2
    again, _, code = _run(cli.main, args)
    assert code == 0 and _rows(again) == []


def test_cli_ber_8psk_interleaved():
    """8PSK with the backwards-read 3-column interleaver on DVB-S2
    R3_5short (the 8PSK r=3/5 pipeline of RESULTS.md at a short frame):
    every frame decodes at 5 dB."""
    out, err, code = _run(cli.main, [
        "ber", "dvbs2:3/5:short", "--device", "cpu", "--modulation", "8PSK",
        "--interleaving", "-3", "--decoder", "Minsumbf16", "--min-ebn0", "5",
        "--max-ebn0", "5", "--step-ebn0", "1", "--max-iter", "15", "--frame-errors", "1",
        "--max-time", "1s", "--batch-size", "16"])
    assert code == 0 and err == ""
    (row,) = _rows(out)
    assert row[0].strip() == "5.00" and int(row[1]) >= 16 and int(row[3]) == 0


@pytest.mark.parametrize("bch", [0, 40])
def test_cli_ber_output_file_ldpc_only_with_bch(tmp_path, bch):
    """``--output-file-ldpc`` is written only with ``--bch-max-errors``:
    the LDPC decoder's own rows, where ``--output-file`` has the BCH
    ones."""
    out, ldpc = tmp_path / "bch.txt", tmp_path / "ldpc.txt"
    _, _, code = _run(cli.main, [
        "ber", "ccsds:1/2:1024", "--device", "cpu", "--decoder", "HLMinsumbf16",
        "--min-ebn0", "1.5", "--max-ebn0", "1.5", "--step-ebn0", "1", "--max-iter", "8",
        "--frame-errors", "10", "--batch-size", "32", "--bch-max-errors", str(bch),
        "--output-file", str(out), "--output-file-ldpc", str(ldpc)])
    assert code == 0
    assert ldpc.exists() == (bch > 0)
    (row,) = (r.split("|") for r in out.read_text().splitlines()[2:])
    if bch:
        header, (ldpc_row,) = ldpc.read_text().splitlines()[:2], (
            r.split("|") for r in ldpc.read_text().splitlines()[2:])
        assert "\n".join(header) == cli._BER_HEADER
        assert ldpc_row[1] == row[1]  # the same frames
        assert int(ldpc_row[3]) > int(row[3]) >= 10  # LDPC errors, then BCH ones


def test_cli_ber_ctrl_c_exits_130_and_resumes(tmp_path, monkeypatch):
    """Ctrl-C during the third step: exit 130, the JAX CLI's message on
    stderr, the two steps done saved; resumed, the sweep gives the rows of
    an uninterrupted one."""
    ckpt = tmp_path / "sweep.json"
    args = ["ber", "ccsds:1/2:1024", "--device", "cpu", "--decoder", "HLMinsumbf16",
            "--min-ebn0", "1.5", "--max-ebn0", "1.5", "--step-ebn0", "1", "--max-iter", "8",
            "--frame-errors", "60", "--batch-size", "16", "--seed", "4"]
    full, _, _ = _run(cli.main, args)
    step = torch_ber.BerTest.step
    calls = []

    def interrupted(self, *a):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return step(self, *a)

    monkeypatch.setattr(torch_ber.BerTest, "step", interrupted)
    out, err, code = _run(cli.main, args + ["--checkpoint", str(ckpt)])
    assert code == 130
    assert err == f"interrupted; resume with --checkpoint {ckpt}\n"
    state = json.loads(ckpt.read_text())
    assert (state["point"], state["step_idx"], state["counters"]["num_frames"]) == (0, 2, 32)
    monkeypatch.setattr(torch_ber.BerTest, "step", step)
    resumed, _, code = _run(cli.main, args + ["--checkpoint", str(ckpt)])
    assert code == 0
    (row,), (full_row,) = _rows(resumed), _rows(full)
    # the same counts; the elapsed time and throughput may differ
    assert row[:9] == full_row[:9]
    _, err, code = _run(cli.main, args[:-2] + ["--checkpoint", str(ckpt)])
    assert "interrupted" not in err


def test_live_reporter_rewrites_the_row(tmp_path):
    """The reporter prints a point's running row and rewrites it in place
    (cursor up, erase line) while the point runs; a new point starts a
    new row; only final rows reach the files."""
    from ldpc_toolbox_torch.simulation.ber import CodeStatistics, Statistics

    def stats(ebn0, frames):
        return Statistics(ebn0_db=ebn0, num_frames=frames, false_decodes=0,
                          total_iterations=frames, average_iterations=1.0, elapsed=1.0,
                          throughput_mbps=1.0, ldpc=CodeStatistics())

    path = tmp_path / "rows.txt"
    buf = io.StringIO()
    with open(path, "w") as f, contextlib.redirect_stdout(buf):
        report = cli._live_reporter(f, None)
        for ebn0, frames, final in ((1.0, 10, False), (1.0, 20, False), (1.0, 30, True),
                                    (2.0, 10, False), (2.0, 40, True)):
            report(stats(ebn0, frames), final)
    rows = [cli._format_progress(stats(e, n), False) for e, n in
            ((1.0, 10), (1.0, 20), (1.0, 30), (2.0, 10), (2.0, 40))]
    up = "\x1b[1A\x1b[2K"
    assert buf.getvalue() == "".join(
        (up if i in (1, 2, 4) else "") + r + "\n" for i, r in enumerate(rows))
    assert path.read_text() == rows[2] + "\n" + rows[4] + "\n"


@pytest.mark.parametrize("args, path", [
    (["mackay-neal", "512", "1024", "6", "3", "42"], "results/mn_512_1024.alist"),
    (["peg", "512", "1024", "3", "7"], "results/peg_512_1024.alist"),
    (["systematic", "results/mn_512_1024.alist"], "results/mn_512_1024_sys.alist"),
], ids=["mackay-neal", "peg", "systematic"])
def test_constructions_reproduce_committed_alists(args, path):
    """The commands of tools/run_results.sh that made the committed alists
    give them again (with ``println!``'s extra newline)."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    out, err, code = _run(cli.main, [a if not a.startswith("results/") else str(root / a)
                                     for a in args])
    assert code == 0 and err == ""
    assert out == (root / path).read_text() + "\n"
