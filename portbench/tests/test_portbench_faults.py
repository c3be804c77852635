"""A run with its timed path broken underneath comes out not correct:
the harness's look for a chip skipped (a CPU run), everything else as a
run does it, one fault of ``faults.py`` at a time; and the same run
unbroken comes out correct."""

import time

import pytest

from portbench import faults, harness


def _run(small_bench, cell, monkeypatch, fault=None):
    if fault:
        build = harness.build_test

        def faulty(config, device):
            test = build(config, device)
            faults.plant(test, fault)
            return test

        monkeypatch.setattr(harness, "build_test", faulty)
    return harness.run_cell(small_bench / "BENCHMARK.json", cell, 4242, 0.2, False,
                            time.perf_counter(), device="cpu", root=small_bench)


@pytest.mark.parametrize("cell", ["small-layered.run", "small-flooding.run"])
@pytest.mark.parametrize("fault", [None, *sorted(faults.FAULTS)])
def test_fault_fails_the_check(small_bench, monkeypatch, cell, fault):
    result = _run(small_bench, cell, monkeypatch, fault)
    assert result["correct"] is (fault is None), result["checks"]
