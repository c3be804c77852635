"""The control, the reference one precision lower in the program's place
(a bfloat16 channel, float8 messages), fails the check: here at a small
size on the CPU, and at each cell's own size on the card."""

import json

import pytest
import torch

from conftest import ROOT
from portbench import check, control, lookup
from portbench.reference.step import LOWER


def test_control_fails_at_a_small_size(small_bench):
    for name in ("small-layered.run", "small-flooding.run"):
        cell = lookup.load_cell(small_bench / "BENCHMARK.json", name, small_bench)
        for numbers in control.control_readings(cell, [3, 2**31 + 1], torch.device("cpu")).values():
            assert not check.correct(numbers, cell.config["limits"]), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's size is the card's")
    c = lookup.load_cell(ROOT / "BENCHMARK.json", cell)
    for numbers in control.control_readings(c, [11, 12, 13], torch.device("cuda")).values():
        assert not check.correct(numbers, c.config["limits"]), numbers


def test_control_is_one_precision_below_the_configuration():
    """The control's types follow from the configuration's: a bfloat16
    channel for float32, float8 messages for bfloat16 storage."""
    for base in ("dvbs2-1_2-bpsk-hlminsumbf16", "dvbs2-3_5-8psk-minsumbf16"):
        config = json.loads((ROOT / "portbench" / "configs" / f"{base}.json").read_text())
        storage = getattr(torch, config["reference"]["storage"])
        assert (LOWER[torch.float32], LOWER[storage]) == (torch.bfloat16, torch.float8_e4m3fn)
