"""A whole run at a CPU size: the shape of the result line, the check's
lines last on standard error, and no JAX in the process."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [("cartpole_solve_b16384", False),
                                        ("cartpole_solve_b16384", True),
                                        ("cartpole_mpc_b1", False)])
def test_result_line(cell, trace):
    rc, line, err = run_cell(cell, trace=trace)
    assert rc == 0
    assert set(KEYS) <= set(line) and list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    spec = harness.load_spec(cell)
    want = spec.per_layer if trace else spec.end_to_end
    got = line["metrics"]
    for m in got.values():
        assert set(m) == {"value", "unit"}
    assert set(got) <= {m["name"] for m in want}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert "forward_ms.solve" in got
    else:
        assert "setup_s" in got and len(got) >= 2
    checks = [s for s in err if s.startswith("check ")]
    assert err[-len(checks):] == checks and len(checks) == len(line["check"])
    for name, c in line["check"].items():
        assert c["value"] <= c["limit"]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxfoo", "ilqg_mujoco_tpux", "ilqg_mujoco_torch_x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN
        for m in harness.forbidden_modules())
    assert "ilqg_mujoco_tpux" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def test_no_jax_in_a_run():
    """A fresh process that runs a cell loads neither JAX nor the JAX
    package (by whole top-level names)."""
    code = (
        "import sys, io, time\n"
        "from benchmark import harness\n"
        "from benchmark.tests.conftest import tiny\n"
        "rc = harness.run('cartpole_mpc_b1', 3, 0.0, True, time.perf_counter(),"
        " device='cpu', tweak=tiny, out=io.StringIO(), err=io.StringIO())\n"
        "import ilqg_mujoco_torch\n"
        "print(rc, sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=harness.REPO, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    rc, names = p.stdout.strip().split(" ", 1)
    tops = set(json.loads(names.replace("'", '"')))
    assert rc == "0"
    assert "ilqg_mujoco_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from benchmark import run
    rc = run.main(["--workload", "cartpole_mpc_b1", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    exits with another code than 0 and prints no result."""
    import shutil
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cartpole_mpc_b1", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
