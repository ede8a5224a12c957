"""The port's CLI (``python -m ilqg_mujoco_torch.cli``), each invocation a
fresh process on the CPU (``--device cpu``) at tiny horizons: the env
registry, the solver knobs, checkpoint/resume at B=1 and B=4 (a resumed run
continues bitwise where a straight run would be), ``--out`` in ``run.py``'s
layout through ``tools/replay.py``, float32, and the refusal to run on the
CPU unless asked.  Independent runs start together to keep the file short."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ("--iters", "2", "--horizon", "6")
TIMEOUT = 300


def _start(args, cpu=True):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    extra = ("--device", "cpu") if cpu else ()
    return subprocess.Popen(
        [sys.executable, "-m", "ilqg_mujoco_torch.cli", *args, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env=env)


def run_many(runs, cpu=True):
    """Start every {name: argv} run at once; returns {name: (rc, stdout,
    stderr)}."""
    procs = {n: _start(a, cpu) for n, a in runs.items()}
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


def ok(res):
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
    """Every run of this file, in two waves: the first holds the
    independent runs and the straight and first-half runs at B=1 (6 = 3 + 3
    frames) and B=4 (4 = 2 + 2); the second resumes the halves, once with a
    wrong --batch.  Returns ({name: npz path}, {name: (rc, stdout,
    stderr)})."""
    d = tmp_path_factory.mktemp("cli")
    p = {n: str(d / f"{n}.npz") for n in ("s1", "a1", "c1", "o1", "oc1",
                                          "s4", "a4", "c4", "o4", "f32")}
    x64 = ("--x64",) + TINY
    res = run_many({
        "unknown": ("walker2d",),
        "tumbler": ("tumbler", "--frames", "2") + x64,
        "assoc": ("pendulum", "--backward", "assoc", "--solve-only") + x64,
        "tassa": ("pendulum", "--mode", "tassa", "--engine", "ad",
                  "--control-limits", "--solve-only") + x64,
        "f32": ("pendulum", "--frames", "2", "--out", p["f32"]) + TINY,
        "s1": ("pendulum", "--frames", "6", "--checkpoint", p["s1"],
               "--out", p["o1"]) + x64,
        "a1": ("pendulum", "--frames", "3", "--checkpoint", p["a1"]) + x64,
        "s4": ("pendulum", "--batch", "4", "--frames", "4", "--checkpoint",
               p["s4"], "--out", p["o4"]) + x64,
        "a4": ("pendulum", "--batch", "4", "--frames", "2", "--checkpoint",
               p["a4"]) + x64})
    for n in ("s1", "a1", "s4", "a4"):
        ok(res[n])
    res.update(run_many({
        "c1": ("pendulum", "--frames", "3", "--resume", p["a1"],
               "--checkpoint", p["c1"], "--out", p["oc1"]) + x64,
        "c4": ("pendulum", "--frames", "2", "--resume", p["a4"],
               "--checkpoint", p["c4"]) + x64,
        "wrong_batch": ("pendulum", "--frames", "2", "--resume", p["a4"],
                        "--batch", "2") + x64}))
    return p, res


def test_cli_rejects_unknown_env(runs):
    rc, _, err = runs[1]["unknown"]
    assert rc != 0
    assert "tumbler" in err      # lists the registry


def test_cli_tumbler_env(runs):
    out = ok(runs[1]["tumbler"])
    assert "env=tumbler" in out and "MPC frames" in out


def test_cli_assoc_backward(runs):
    out = ok(runs[1]["assoc"])
    assert "backward=assoc" in out and "cost trace" in out
    assert "solve (first)" in out and "solve (steady)" in out


def test_cli_tassa_control_limits(runs):
    out = ok(runs[1]["tassa"])
    assert "mode=tassa engine=ad" in out and "cost trace" in out
    trace = re.search(r"cost trace: \[([^\]]*)\]", out).group(1).split()
    assert len(trace) == 2 and np.all(np.isfinite(np.float64(trace)))


def test_cli_checkpoint_resume_roundtrip(runs):
    p, res = runs
    assert "checkpointed" in ok(res["a1"])
    out = ok(res["c1"])
    t = float(re.search(r"resumed from \S+ \(t=([0-9.]+)", out).group(1))
    assert t > 0.0
    assert int(np.load(p["a1"])["extra/frames"]) == 3
    # 3 + 3 resumed frames end where 6 straight frames end, bit for bit
    _same_npz(p["s1"], p["c1"])
    straight, tail = np.load(p["o1"]), np.load(p["oc1"])
    for k in straight.files:
        np.testing.assert_array_equal(straight[k][3:], tail[k], err_msg=k)


def test_cli_batched_checkpoint_resume(runs):
    p, res = runs
    assert "env-frames/s" in ok(res["s4"])
    assert "B=4" in ok(res["c4"])
    _same_npz(p["s4"], p["c4"])
    rc, _, err = res["wrong_batch"]
    assert rc != 0 and "--batch 2" in err
    o = np.load(p["o4"])
    assert sorted(o.files) == ["costs", "qpos"]
    assert o["qpos"].shape == (4, 2) and o["costs"].shape == (4, 4)


def test_cli_out_renders_through_replay(runs, tmp_path):
    """--out at B=1 has run.py's keys and shapes, and tools/replay.py
    renders it unchanged."""
    pytest.importorskip("matplotlib")
    sys.path.insert(0, str(ROOT))
    from tools import replay
    path = runs[0]["o1"]
    o = np.load(path)
    shapes = {k: o[k].shape for k in o.files}
    assert shapes == {"qpos": (6, 2), "qvel": (6, 2), "ctrl": (6, 1),
                      "cost_trace": (6, 2), "step_cost": (6,)}
    artifact = replay.replay(path, "pendulum", out=str(tmp_path / "f"),
                             every=2, width=240, height=180)
    assert artifact is not None and pathlib.Path(artifact).exists()
    assert pathlib.Path(artifact).stat().st_size > 1000


def test_cli_float32_without_x64(runs):
    assert "dtype=float32" in ok(runs[1]["f32"])
    o = np.load(runs[0]["f32"])
    for k in o.files:
        assert o[k].dtype == np.float32, k
        assert np.all(np.isfinite(o[k])), k


def test_cli_without_device_needs_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    rc, out, err = run_many({"x": ("pendulum", "--frames", "1") + TINY},
                            cpu=False)["x"]
    assert rc != 0
    assert "device='cpu'" in err and "MPC frames" not in out
