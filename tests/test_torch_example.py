"""The external-decoder example of the port
(``examples/external_decoder_ber_torch.py``) against the JAX package's
(``examples/external_decoder_ber.py``): its offset min-sum check rule
equals the JAX one on seeded inputs, with and without a validity mask, and
the script runs its two-point sweep on the CPU. The same arithmetic's
decodes of a lifted code are in test_torch_plane_gather.py."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = "examples/external_decoder_ber_torch.py"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("masked", [False, True])
def test_offset_min_sum_matches_jax(masked):
    jax_rule = _load("examples/external_decoder_ber.py", "jax_external_example").OffsetMinSum()
    rule = _load(SCRIPT, "torch_external_example").OffsetMinSum()
    rng = np.random.default_rng(12)
    rows, d, batch = 40, 7, 16
    # quarter steps: ties for the first and second minimum, zeros, and
    # magnitudes under the offset
    x = (rng.integers(-12, 13, (rows, d, batch)) / 4).astype(np.float32)
    mask = rng.random((rows, d)) < 0.8 if masked else None
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.from_numpy(mask)
    want = np.asarray(jax_rule.check_messages(jnp.asarray(x), mask_j))
    got = rule.check_messages(torch.from_numpy(x), mask_t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    assert (want == 0).any() and (want != 0).any()


def test_example_runs_its_sweep_on_the_cpu():
    """The script as ``python SCRIPT --device cpu`` runs it, in a process of
    its own, which imports no jax and nothing of the JAX package."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{SCRIPT!r}, '--device', 'cpu']\n"
        f"runpy.run_path({SCRIPT!r}, run_name='__main__')\n"
        "assert not [k for k in sys.modules if k == 'jax' or k.startswith('ldpc_toolbox_tpu')]\n"
    )
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    rows = proc.stdout.splitlines()
    assert [r.split(":")[0] for r in rows] == ["Eb/N0  2.0 dB", "Eb/N0  3.0 dB"], rows
    for r in rows:
        assert "frames=" in r and "FER=" in r
