"""What the benchmark loads: neither JAX nor the JAX package, judged by
whole top-level module names, and in the reference not the port either."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "ldpc_toolbox_tpu"}


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    tops = _loaded("import runpy; runpy.run_path('portbench/run.py', run_name='not_main')")
    assert "ldpc_toolbox_torch" in tops  # the program under test is loaded
    assert not tops & JAX


@pytest.mark.parametrize("module", ["control", "harness", "check", "trace", "faults"])
def test_harness_modules_load_no_jax(module):
    tops = _loaded(f"import sys; sys.path.insert(0, '.'); import portbench.{module}")
    assert not tops & JAX


def test_reference_loads_neither_jax_nor_the_port():
    modules = ["channel", "counters", "dvbs2", "encode", "graph", "minsum", "step"]
    tops = _loaded("import sys; sys.path.insert(0, '.')\n" + "\n".join(
        f"import portbench.reference.{m}" for m in modules))
    assert not tops & (JAX | {"ldpc_toolbox_torch"})
