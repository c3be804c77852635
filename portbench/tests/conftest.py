"""Fixtures of the benchmark's CPU tests: a throwaway benchmark of small
cells (short DVB-S2 frames, a few frames, few iterations) in a temporary
directory, laid out as ``portbench/`` is."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: small forms of the benchmark's configurations: (name, config, code)
SMALL = (
    ("small-layered", "dvbs2-1_2-bpsk-hlminsumbf16", "dvbs2:1/2:short"),
    ("small-flooding", "dvbs2-3_5-8psk-minsumbf16", "dvbs2:3/5:short"),
)
#: traffic of the small cells: Eb/N0 where some frames converge
SMALL_EBN0 = {"small-layered": 2.5, "small-flooding": 5.5}


def write_small(root: Path, batch=4, max_iter=6):
    """A benchmark of the small cells under ``root``: its BENCHMARK.json,
    configs/, traffic/ and copies of metrics/ and roofline/."""
    for d in ("metrics", "roofline"):
        shutil.copytree(HERE / d, root / d)
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name, base, code in SMALL:
        config = json.loads((HERE / "configs" / f"{base}.json").read_text())
        config.update(code=code, batch_size=batch, max_iter=max_iter)
        (root / "configs" / f"{name}.json").write_text(json.dumps(config))
        (root / "traffic" / f"{name}.json").write_text(
            json.dumps({"ebn0_db": SMALL_EBN0[name]}))
        bench["workloads"].append({"name": f"{name}.run", "config": name,
                                   "traffic": name, "chips": 1, "why": "small"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def small_bench(tmp_path):
    return write_small(tmp_path)
