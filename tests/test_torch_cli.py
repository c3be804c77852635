"""The port's ``ber`` command line on the code specs: ``ccsds:RATE:K``
resolves to the JAX package's parity-check matrix and lifted graph and
runs a sweep on the CPU; an alist path and ``ccsds-c2``, which the JAX
package's ``ber`` also takes, exit with a message that names the ROADMAP
item they wait for (A8, A9)."""

import numpy as np
import pytest

from ldpc_toolbox_tpu import cli as jax_cli
from ldpc_toolbox_torch import cli


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


@pytest.mark.parametrize("spec,item", [("ccsds-c2", "ROADMAP A9"), ("alist", "ROADMAP A8"),
                                       ("mackay_96.33.964", "ROADMAP A8")])
def test_cli_ber_refuses_specs_it_cannot_run(spec, item, capsys, tmp_path):
    if spec == "alist":
        spec = str(tmp_path / "h.alist")
        (tmp_path / "h.alist").write_text("4 2\n2 4\n1 1 1 1\n2 2\n1 2\n1 2\n1 2\n1 2\n"
                                          "1 2 3 4\n1 2 3 4\n")
    with pytest.raises(SystemExit) as exit_:
        cli.main(["ber", spec, "--device", "cpu", "--min-ebn0", "1", "--max-ebn0", "1",
                  "--step-ebn0", "1"])
    assert exit_.value.code == 1
    err = capsys.readouterr().err
    assert err.startswith("error: invalid code spec") and item in err


def test_code_help_names_the_specs():
    action = next(a for a in cli.build_parser()._subparsers._group_actions[0]
                  .choices["ber"]._actions if a.dest == "code")
    for spec in ("dvbs2:RATE[:short]", "5g:BG:Z", "ccsds:RATE:K", "1024, 4096 or 16384"):
        assert spec in action.help
