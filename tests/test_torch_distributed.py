"""PyTorch port, multi-process runs on the CPU: the counterparts of
tests/test_distributed.py.  The CLI's ``--mesh 2 --device cpu`` (two
``gloo`` ranks, one torch thread each) writes the npz keys of ``--mesh 0``
with the same values bit for bit (the blocks run the same operations as
the whole batch on the CPU), and a ``--mesh 2`` checkpoint resumed at
``--mesh 2`` equals a straight ``--mesh 0`` run.  ``--mesh`` refuses a
batch it does not divide and a batch of one; ``initialize`` does nothing
for one process and refuses ``nccl`` off a card; it, ``make_mesh`` and
``launch`` refuse a card where there is none; a rank that raises fails the
launch.  ``weak_scaling``'s lines carry
the JAX tool's keys (read from tools/weak_scaling.py with ``ast``)."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ilqg_mujoco_torch.parallel import batch, distributed
from ilqg_mujoco_torch.tools import distributed_check, weak_scaling

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUN = ("pendulum", "--device", "cpu", "--x64", "--batch", "8", "--horizon",
       "10", "--iters", "3")
TIMEOUT = 300


def _run_many(runs):
    """Start every {name: argv} CLI run at once; returns {name: (rc,
    stdout, stderr)}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", "ilqg_mujoco_torch.cli", *a],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env=env) for n, a in runs.items()}
    res = {}
    try:
        for n, p in procs.items():
            out, err = p.communicate(timeout=TIMEOUT)
            res[n] = (p.returncode, out, err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


def _ok(res):
    rc, out, err = res
    assert rc == 0, f"CLI failed:\n{out}\n{err}"
    return out


def _same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two waves: 2 frames at --mesh 0 and --mesh 2 (each with --out and
    --checkpoint), 4 straight frames at --mesh 0, the refused runs; then 2
    frames resumed at --mesh 2 from the --mesh 2 checkpoint."""
    d = tmp_path_factory.mktemp("mesh")
    p = {n: str(d / f"{n}.npz") for n in ("o0", "o2", "c0", "c2", "c4",
                                          "r2")}
    res = _run_many({
        "mesh0": RUN + ("--frames", "2", "--out", p["o0"], "--checkpoint",
                        p["c0"]),
        "mesh2": RUN + ("--frames", "2", "--mesh", "2", "--out", p["o2"],
                        "--checkpoint", p["c2"]),
        "straight": RUN + ("--frames", "4", "--checkpoint", p["c4"]),
        "mesh3": RUN + ("--frames", "1", "--mesh", "3"),
        "batch1": ("pendulum", "--device", "cpu", "--batch", "1", "--mesh",
                   "2", "--frames", "1")})
    _ok(res["mesh2"])
    res.update(_run_many({
        "resumed": ("pendulum", "--device", "cpu", "--x64", "--horizon", "10",
                    "--iters", "3", "--frames", "2", "--mesh", "2",
                    "--resume", p["c2"], "--checkpoint", p["r2"])}))
    return p, res


def test_cli_mesh2_equals_mesh0(runs):
    p, res = runs
    out = _ok(res["mesh2"])
    _ok(res["mesh0"])
    assert "mesh: 2 ranks, 4 instances each, gloo" in out
    assert "rank 0: cpu, rows [0, 4)" in out and "rank 1: cpu, rows [4, 8)" \
        in out
    assert "2 frames x 8 instances" in out
    _same_npz(p["o2"], p["o0"])
    _same_npz(p["c2"], p["c0"])
    z = np.load(p["o2"])
    assert z["qpos"].shape == (8, 2) and z["costs"].shape == (2, 8)


def test_cli_mesh_checkpoint_resumes_at_mesh(runs):
    p, res = runs
    out = _ok(res["resumed"])
    assert "resumed from" in out and "B=8, frames so far 2" in out
    _same_npz(p["r2"], p["c4"])


@pytest.mark.parametrize("name, message", [
    ("mesh3", "--mesh 3 does not divide the batch of 8"),
    ("batch1", "--mesh requires --batch > 1")])
def test_cli_mesh_refuses(runs, name, message):
    rc, _, err = runs[1][name]
    assert rc == 2 and message in err, err


def test_initialize_one_process_does_nothing(monkeypatch):
    monkeypatch.delenv("ILQG_NUM_PROCESSES", raising=False)
    distributed.initialize()
    distributed.initialize(num_processes=1, device="cpu")
    assert not dist.is_initialized()
    mesh = batch.make_mesh(1, "cpu")
    assert (mesh.rank, mesh.world, mesh.device) == (0, 1,
                                                    torch.device("cpu"))
    with pytest.raises(ValueError, match="process group of 1"):
        batch.make_mesh(2, "cpu")


def test_nccl_or_a_card_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu",
                               backend="nccl")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.launch(distributed_check.rank_mean, 2, torch.zeros(2))
    assert not dist.is_initialized()


def test_a_rank_that_raises_fails_the_launch(monkeypatch):
    """Each rank refuses a global batch of 3 over 2 ranks: the launch
    raises, with the rank's error, and leaves no rank running."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = distributed_check.Config(batch=3, horizon=2, iterations=1)
    with pytest.raises(Exception, match="does not split evenly"):
        distributed.launch(distributed_check.rank_check, 2, cfg,
                           device="cpu", timeout=TIMEOUT)


def _jax_row_keys():
    """The keys of each curve's rows in tools/weak_scaling.py: the dict
    literals with a "curve" key, by curve ("fixed_total" has
    "vs_unsharded")."""
    tree = ast.parse((ROOT / "tools" / "weak_scaling.py").read_text())
    rows = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            keys = {k.value for k in node.keys}
            if "curve" in keys:
                curve = ("fixed_total" if "vs_unsharded" in keys
                         else "fixed_per_device")
                rows.setdefault(curve, set()).update(keys)
    return rows


def test_weak_scaling_lines_carry_the_jax_keys(monkeypatch, capsys):
    calls = []

    def fake_measure(n, batch_size, reps, trials, device=None,
                     shared=False):
        calls.append((n, batch_size, shared))
        return 100.0 * (n + 1), {"trials": trials}, 1.0 + n
    monkeypatch.setattr(weak_scaling, "measure", fake_measure)
    assert weak_scaling.main(["--reps", "2", "--trials", "1"], "cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    want = _jax_row_keys()
    assert want["fixed_total"] >= {"devices", "time_s", "vs_unsharded",
                                   "iters_per_s"}
    assert want["fixed_per_device"] >= {"batch", "per_device_time_vs_n1"}
    for line in lines:
        assert set(line) >= want[line["curve"].rsplit("_", 1)[0]], line
        assert line["device"] == "cpu"
    total = [x for x in lines if x["curve"] == "fixed_total_B1024"]
    per = [x for x in lines if x["curve"] == "fixed_per_device_PB256"]
    assert [x["devices"] for x in total] == [1, 2, 0]
    assert [x["devices"] for x in per] == [1, 2]
    assert len(total) + len(per) == len(lines)
    assert calls == [(0, 1024, False), (1, 1024, False), (2, 1024, False),
                     (1, 256, False), (2, 512, False)]
