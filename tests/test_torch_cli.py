"""The port's ``ber`` command line on the code specs: ``ccsds:RATE:K``
resolves to the JAX package's parity-check matrix and lifted graph and
runs a sweep on the CPU; so do ``ccsds-c2`` (through the encode-side
permutation) and an alist path (the generic decode), which exits as the
JAX package's ``ber`` does when it cannot be read."""

import math

import numpy as np
import pytest

from ldpc_toolbox_tpu import cli as jax_cli
from ldpc_toolbox_torch import cli

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
