"""Sharded BER over ranks (``ldpc_toolbox_torch/parallel``, ``BerTest`` with a
``mesh``, ``ber --shard`` and ``--no-lifted``) on the CPU.

Two processes join over gloo on localhost through
``parallel.multihost.initialize`` and run the three scenarios of the JAX
package's tests/test_multihost.py on ``global_mesh("cpu")``, each rank on
the CPU: one step of a MacKay-Neal code, whose summed counters are the same on
both ranks and equal to the unsharded step's; one step of a lifted 5G BG2
z=16 ``HLMinsumf32`` decode, equal to the unsharded step's; and a two-point
sweep under the stop rule, crashed after point 0, resumed from each rank's
own checkpoint, reported on rank 0 only, whose statistics equal a
single-process run's. A fourth: a clock that only rank 1 reads past
``max_time`` ends both ranks at the same step. Then each rank ends its
group through ``multihost.shutdown`` and exits 0; ``ber --shard`` over two
processes does the same. In one process ``--shard``
is a mesh of one and prints the deterministic columns of a run without
it; ``--no-lifted`` decodes a standards code as its alist does."""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from ldpc_toolbox_torch import cli
from ldpc_toolbox_torch.parallel import Mesh, default_mesh, shard_batch
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.sparse import SparseMatrix

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

_WORKER = r"""
import json, os, sys, time

pid, port, ckpt_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import torch
torch.set_num_threads(1)

from ldpc_toolbox_torch.parallel.multihost import global_mesh, initialize, shutdown

initialize(init_method=f"tcp://localhost:{port}", world_size=2, rank=pid)
mesh = global_mesh("cpu")
assert (mesh.rank, mesh.size) == (pid, 2), mesh
assert mesh.device == torch.device("cpu"), mesh

from ldpc_toolbox_torch.codes.nr5g import BaseGraph
from ldpc_toolbox_torch.decoder.lifted import LiftedGraph, nr5g_maps
from ldpc_toolbox_torch.mackay_neal import Config
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.simulation import ber
from ldpc_toolbox_torch.simulation.ber import step_generator
from ldpc_toolbox_torch.systematic import parity_to_systematic


def say(tag, value):
    print(tag + " " + json.dumps(value, sort_keys=True), flush=True)


# scenario 1: one step of a generic decode, batch sharded over the ranks
h = parity_to_systematic(Config(nrows=16, ncols=32, wr=6, wc=3).run(4))
kw = dict(h=h, decoder_implementation="Phif32", ebn0s_db=[4.0], max_frame_errors=1,
          max_iterations=5, batch_size=8, seed=0, device="cpu")
sharded = BerTestBuilder(**kw, mesh=mesh).build().step(step_generator(0, 0, 0, "cpu"), 0.7)
local = BerTestBuilder(**kw).build().step(step_generator(0, 0, 0, "cpu"), 0.7)
assert sharded == local, (sharded, local)
say("COUNTERS", sharded)

# scenario 2: the lifted layered decode (the kernels' plain versions here)
bg, z = BaseGraph.BG2, 16
h5g = bg.h(z)
kw5g = dict(h=h5g, lifted_graph=LiftedGraph.from_sparse(h5g, *nr5g_maps(bg, z)),
            decoder_implementation="HLMinsumf32", ebn0s_db=[6.0], max_frame_errors=1,
            max_iterations=4, batch_size=8, seed=1, device="cpu")
sharded = BerTestBuilder(**kw5g, mesh=mesh).build().step(step_generator(1, 0, 0, "cpu"), 0.5)
local = BerTestBuilder(**kw5g).build().step(step_generator(1, 0, 0, "cpu"), 0.5)
assert sharded == local, (sharded, local)
say("LIFTED", sharded)

# scenario 3: the whole sweep loop, a crash after point 0, resumed from
# this rank's own checkpoint; the reporter on rank 0 only
ckpt = f"{ckpt_dir}/sweep.{pid}.ckpt"
reports = []


def reporter(stats, final):
    if final:
        reports.append(stats.ebn0_db)


kw = dict(h=h, decoder_implementation="Phif32", ebn0s_db=[3.0, 5.0], max_frame_errors=8,
          max_iterations=5, batch_size=8, seed=3, checkpoint_path=ckpt, mesh=mesh,
          device="cpu")


def build(kw):
    t = BerTestBuilder(**kw, reporter=reporter if pid == 0 else None).build()
    t.p.report_interval = 1e9  # only the end-of-point checkpoints
    return t


t1 = build(kw)
save = t1._save_checkpoint


def crash_after_point0(state):
    save(state)
    if state["point"] == 1:
        raise KeyboardInterrupt


t1._save_checkpoint = crash_after_point0
try:
    t1.run()
    raise SystemExit("expected the simulated crash")
except KeyboardInterrupt:
    pass
assert os.path.exists(ckpt)
stats = build(kw).run()
assert [s.ebn0_db for s in stats] == [3.0, 5.0], stats
assert all(s.ldpc.frame_errors >= 8 for s in stats), stats
assert reports == ([3.0, 5.0] if pid == 0 else []), reports


def det(stats):
    return [{"ebn0_db": s.ebn0_db, "num_frames": s.num_frames,
             "false_decodes": s.false_decodes, "total_iterations": s.total_iterations,
             "bit_errors": s.ldpc.bit_errors, "frame_errors": s.ldpc.frame_errors,
             "correct_iterations": s.ldpc.correct_iterations} for s in stats]


say("SWEEP", det(stats))
local = BerTestBuilder(**dict(kw, mesh=None, checkpoint_path=None)).build().run()
assert det(local) == det(stats), (det(local), det(stats))
print("SWEEPLOCAL ok", flush=True)

# scenario 4: only rank 1's clock passes max_time (100 s) after its fourth
# reading; the stop rule reads the largest clock, so both ranks end after
# the same step
if pid == 1:
    calls = [0]
    real = time.monotonic

    class Clock:
        @staticmethod
        def monotonic():
            calls[0] += 1
            return real() + (1e6 if calls[0] > 4 else 0.0)

    ber.time = Clock
kw = dict(h=h, decoder_implementation="Phif32", ebn0s_db=[1.0], max_frame_errors=10**9,
          max_iterations=5, batch_size=8, seed=5, max_run_time=100.0, mesh=mesh,
          device="cpu")
(s,) = BerTestBuilder(**kw).build().run()
say("CLOCK", s.num_frames)

# the group ends here, its threads joined, though meshes remain
shutdown()
try:
    mesh.group
    raise SystemExit("the mesh kept its process group")
except RuntimeError:
    pass
print("SHUTDOWN ok", flush=True)
"""


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """The two ranks' standard outputs, the four scenarios run once."""
    tmp = tmp_path_factory.mktemp("ranks")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


def _grab(outs, tag):
    vals = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
        assert lines, out
        vals.append(json.loads(lines[-1][len(tag) + 1 :]))
    return vals


def test_two_rank_ber_step(workers):
    """Each rank asserted its sharded step equal to its unsharded one."""
    a, b = _grab(workers, "COUNTERS")
    assert a == b and a["num_frames"] == 8


def test_two_rank_lifted_step(workers):
    a, b = _grab(workers, "LIFTED")
    assert a == b and a["num_frames"] == 8


def test_two_rank_sweep_checkpoint_resume(workers):
    a, b = _grab(workers, "SWEEP")
    assert a == b and [p["ebn0_db"] for p in a] == [3.0, 5.0]
    for out in workers:
        assert "SWEEPLOCAL ok" in out


def test_one_rank_clock_stops_both_ranks(workers):
    a, b = _grab(workers, "CLOCK")
    assert a == b and 8 <= a < 10**6


def test_shutdown_ends_the_group(workers):
    """``multihost.shutdown`` ended each rank's group, which no mesh kept
    alive, and both ranks then exited 0 (the fixture's assertion)."""
    for out in workers:
        assert "SHUTDOWN ok" in out


def test_default_mesh_has_no_cpu_fallback():
    """With no device named a mesh decodes on ``cuda:LOCAL_RANK``; on a
    machine without a card that raises (as the kernels' build does), in
    ``default_mesh`` and in ``global_mesh``, and never becomes the CPU."""
    from ldpc_toolbox_torch.parallel.multihost import global_mesh

    for make in (default_mesh, global_mesh):
        if torch.cuda.is_available():
            assert make().device == torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make("cuda:0")
        assert make("cpu").device == torch.device("cpu")


def test_mesh_of_one_and_batch_split():
    mesh = default_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(shard_batch(x, mesh), x)
    third = Mesh(group=None, rank=2, size=3, device=torch.device("cpu"))
    assert torch.equal(shard_batch(x, third), x[4:])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:5], third)
    h = SparseMatrix.from_alist_file(REPO / "results/mn_512_1024_sys.alist")
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        BerTestBuilder(h=h, batch_size=8, mesh=third, device="cpu").build()


def _rows(args, tmp_path):
    """The final rows of a ``ber`` run (its ``--output-file``) without the
    throughput and elapsed columns."""
    out = tmp_path / "rows.txt"
    cli.main(["ber", *args, "--device", "cpu", "--min-ebn0", "0", "--max-ebn0", "1",
              "--step-ebn0", "1", "--max-iter", "10", "--frame-errors", "40",
              "--batch-size", "64", "--decoder", "HLMinsumbf16", "--output-file", str(out)])
    rows = [r.split("|")[:-2] for r in out.read_text().splitlines()[2:]]
    assert [float(r[0]) for r in rows] == [0.0, 1.0]
    return rows


def test_two_rank_ber_cli_exits_cleanly(tmp_path):
    """``python -m ldpc_toolbox_torch ber ... --shard`` in two processes
    (gloo, the CPU, torchrun's environment variables by hand): both ranks
    exit 0, through ``multihost.shutdown``, and rank 0's rows are a
    single-process run's deterministic columns."""
    alist = str(REPO / "results/mn_512_1024_sys.alist")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "sharded.txt"
    args = [sys.executable, "-m", "ldpc_toolbox_torch", "ber", alist, "--shard",
            "--device", "cpu", "--min-ebn0", "0", "--max-ebn0", "1", "--step-ebn0", "1",
            "--max-iter", "10", "--frame-errors", "40", "--batch-size", "64",
            "--decoder", "HLMinsumbf16", "--output-file", str(out)]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    procs = [
        subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=tmp_path)
        for r in range(2)
    ]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (stdout, err) in zip(procs, results):
        assert p.returncode == 0, err[-4000:]
    assert results[0][0].startswith(cli._BER_HEADER) and results[1][0] == ""
    rows = [r.split("|")[:-2] for r in out.read_text().splitlines()[2:]]
    assert rows == _rows([alist], tmp_path)


def test_shard_on_a_mesh_of_one(tmp_path, capsys):
    assert _rows(["5g:2:16", "--shard"], tmp_path) == _rows(["5g:2:16"], tmp_path)
    assert capsys.readouterr().out.startswith(cli._BER_HEADER)


def test_no_lifted_decodes_the_generic_path(tmp_path, capsys):
    """``--no-lifted`` on ``5g:2:16`` gives the rows of its H as an alist
    (the generic parity-check path), which differ from the lifted ones:
    the two schedules order their layers apart."""
    from ldpc_toolbox_torch.codes.nr5g import BaseGraph

    alist = tmp_path / "bg2z16.alist"
    alist.write_text(BaseGraph.BG2.h(16).alist())
    generic = _rows([str(alist)], tmp_path)
    assert _rows(["5g:2:16", "--no-lifted"], tmp_path) == generic
    assert _rows(["5g:2:16"], tmp_path) != generic
