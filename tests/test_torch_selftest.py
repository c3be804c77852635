"""The port's ``selftest`` (``ldpc_toolbox_torch/selftest.py`` and the
``selftest`` subcommand) on the CPU, where both of its sides are torch
ops: the kernels' plain versions against the plane-gather flooding path
and the plain layered path. Every family passes at a small batch; the
subcommand prints the JAX command line's ``OK  ``/``FAIL`` lines and exits
1 naming a family whose plane path was broken."""

import functools

import pytest
import torch

from ldpc_toolbox_torch import cli, selftest
from ldpc_toolbox_torch.decoder import lifted_flooding

torch.set_num_threads(1)

#: frames a family here (the command line runs 128)
BATCH = 16


def test_run_selftest_passes_every_family():
    lines = []
    failures = selftest.run_selftest(batch=BATCH, device="cpu",
                                     log=lambda *a: lines.append(a))
    assert failures == []
    assert [name for name, _, _ in lines] == selftest.SELFTEST_FAMILIES
    assert all(ok for _, ok, _ in lines)
    assert {"Minsumf32", "HLMinsumf32", "c2:HLMinsumbf16"} <= set(selftest.SELFTEST_FAMILIES)
    assert len(selftest.SELFTEST_FAMILIES) == 14


@pytest.fixture
def small_batch(monkeypatch):
    monkeypatch.setattr(selftest, "run_selftest",
                        functools.partial(selftest.run_selftest, batch=BATCH))


def test_selftest_command_exits_0(small_batch, capsys):
    cli.main(["selftest", "--device", "cpu", "--families", "Minsumbf16,HLMinstarapproxi8",
              "--max-iter", "6"])
    out = capsys.readouterr().out.splitlines()
    assert [line[:4] for line in out] == ["OK  ", "OK  "]
    assert out[0].split()[1] == "Minsumbf16" and out[1].split()[1] == "HLMinstarapproxi8"
    assert f"/{BATCH}, success match {BATCH}/{BATCH}" in out[0]


def test_selftest_names_a_broken_plane_path(small_batch, monkeypatch, capsys):
    """One bit of one converged frame flipped on the plane path: the
    family fails, the other passes, and the command exits 1."""
    real = lifted_flooding.plane_flooding_decode

    def flipped(*args):
        out = real(*args)
        frame = int(out["success"].nonzero()[0, 0])
        out["codeword"][frame, 5] ^= 1
        return out

    monkeypatch.setattr(lifted_flooding, "plane_flooding_decode", flipped)
    with pytest.raises(SystemExit) as exit_:
        cli.main(["selftest", "--device", "cpu", "--families", "HLMinsumbf16,Minsumbf16"])
    assert exit_.value.code == 1
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert lines[0].startswith("OK   HLMinsumbf16")
    assert lines[1].startswith("FAIL Minsumbf16")
    assert "selftest failed: Minsumbf16" in captured.err
