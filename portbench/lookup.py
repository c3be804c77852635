"""Finds a cell's parts by the names in ``BENCHMARK.json``, so that a new
cell, configuration, traffic mix or metric is files added and none
edited:

* ``configs/<config>.json``: the deployment (code, modulation,
  interleaving, decoder, iterations, batch, the reference's parts and the
  limits of ``check.py``);
* ``traffic/<traffic>.json``: the mix's parameters (``ebn0_db``);
* ``metrics/<metric>.py``: the reader of a per-layer metric, ``read(ctx)``
  returning a number or None;
* ``roofline/<family>.py``: the operations and bytes of a decoder rule
  family (the configuration's ``roofline``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "Cell", "load_cell", "metric_reader", "roofline"]

HERE = Path(__file__).resolve().parent


class Cell:
    """A workload of the benchmark with its configuration, its traffic and
    the metrics it reports: ``end_to_end`` and ``per_layer``, each a list
    of the benchmark's metric entries."""

    def __init__(self, bench: dict, name: str, root: Path = HERE):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in the benchmark")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = _json(Path(root) / "configs" / f"{self.entry['config']}.json")
        self.traffic = _json(Path(root) / "traffic" / f"{self.entry['traffic']}.json")
        self.end_to_end = bench["end_to_end"]
        self.per_layer = bench["per_layer"]


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(bench_path: Path, name: str, root: Path = HERE) -> Cell:
    return Cell(_json(Path(bench_path)), name, root)


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = HERE):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = Path(root) / "metrics" / f"{name}.py"
    return _module(path, f"portbench_metric_{name.replace('.', '_').replace('-', '_')}").read


def roofline(family: str, root: Path = HERE):
    """The module ``roofline/<family>.py``."""
    return _module(Path(root) / "roofline" / f"{family}.py", f"portbench_roofline_{family}")
