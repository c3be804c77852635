"""A cell made of files alone: a throwaway configuration, traffic mix and
per-layer metric, found by the harness through the names of its
BENCHMARK.json, with no file of the benchmark edited."""

import json
import time

import torch

from portbench import harness


def test_a_new_cell_is_files_added(small_bench):
    (small_bench / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    (small_bench / "traffic" / "brand_new.json").write_text(json.dumps({"ebn0_db": 3.0}))
    bench = json.loads((small_bench / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "small-layered.brand_new", "config": "small-layered",
                               "traffic": "brand_new", "chips": 1, "why": "new"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "sweep",
                               "moves": "info_mbps"})
    (small_bench / "BENCHMARK.json").write_text(json.dumps(bench))
    result = harness.run_cell(small_bench / "BENCHMARK.json", "small-layered.brand_new",
                              7, 0.3, True, time.perf_counter(), device="cpu",
                              root=small_bench)
    assert result["correct"]
    assert result["metrics"]["steps_seen"]["value"] == result["attempted"] >= 1
    assert "iterations_mean" in result["metrics"]
    assert list(result)[-1] == "checks"


def test_untraced_run_reports_the_end_to_end_metrics(small_bench):
    result = harness.run_cell(small_bench / "BENCHMARK.json", "small-flooding.run",
                              2**31 + 99, 0.3, False, time.perf_counter(), device="cpu",
                              root=small_bench)
    assert result["correct"]
    assert set(result["metrics"]) == {"info_mbps", "step_ms_p95", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_kept_bytes_counts_each_storage_once():
    """What the window keeps for the check, subtracted from the memory
    peak: a storage shared by two kept tensors counts once."""
    llr = torch.zeros(4, 10)
    out = {"codeword": torch.zeros(4, 10, dtype=torch.uint8), "iterations": torch.zeros(4)}
    step = {"msg": llr[:, :5], "cw": torch.zeros(4, 10, dtype=torch.uint8), "llr": llr, "out": out}
    assert harness.kept_bytes([step, dict(step)]) == 160 + 40 + 40 + 16
