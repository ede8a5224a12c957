"""The port's timing and artifact tools against the JAX package's
``tools/perf_breakdown.py`` and ``tools/humanoid_balance.py``, on the CPU.

The JAX tools are read, not run (each would compile a batched solve):
their JSON keys, npz arrays and summary fields are taken from their
source.  ``perf_breakdown`` runs on the cart-pole compat+fd at B=2, REPS=1;
its constraint-row count equals the JAX package's on the hopper, computed
eagerly as the JAX tool computes it (exact: a count).
``humanoid_balance`` runs 1 frame at horizon 4 and 1 iteration, and once
with a stand-in MPC step that drops the torso, which must abort the run
and write ``.failed.npz``."""

import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from ilqg_mujoco_torch import mpc
from ilqg_mujoco_torch.kernels import riccati
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.tools import humanoid_balance, perf_breakdown
from ilqg_mujoco_tpu.models import envs as jenvs
from ilqg_mujoco_tpu.physics import collision as jcollision
from ilqg_mujoco_tpu.physics import constraint as jconstraint
from ilqg_mujoco_tpu.physics import smooth as jsmooth
from ilqg_mujoco_tpu.physics.model import make_state as jmake_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
TEST_BALANCE = ROOT / "tests" / "test_balance_artifact.py"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The solves here are at B=2, too small for torch's intra-op threads,
    which only add CPU time beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(tool):
    return ast.parse((ROOT / "tools" / tool).read_text())


def _json_keys(tool):
    """The keys of the dict literal that ``tool`` passes to json.dumps."""
    for node in ast.walk(_tree(tool)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps of a dict literal in {tool}")


def _summary_fields():
    for node in ast.walk(_tree("humanoid_balance.py")):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "summary"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary dict in tools/humanoid_balance.py")


def _npz_keys():
    for node in ast.walk(_tree("humanoid_balance.py")):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "savez_compressed"):
            return [kw.arg for kw in node.keywords]
    raise AssertionError("no savez_compressed in tools/humanoid_balance.py")


@pytest.fixture
def knobs(monkeypatch):
    def set_(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(k, str(v))
    for k in ("ENV", "BATCH", "MODE", "ENGINE", "REPS"):
        monkeypatch.delenv(f"ILQG_BENCH_{k}", raising=False)
    for k in ("FRAMES", "HORIZON", "ITERS", "ENGINE", "LIMITS", "ALPHAS",
              "F64"):
        monkeypatch.delenv(f"ILQG_HUM_{k}", raising=False)
    return set_


def test_perf_breakdown_line(knobs, capsys, monkeypatch):
    """The cart-pole compat+fd at B=2, its solver cut to N=6 and 3
    iterations."""
    knobs(ILQG_BENCH_ENV="pendulum", ILQG_BENCH_MODE="compat",
          ILQG_BENCH_ENGINE="fd", ILQG_BENCH_BATCH=2, ILQG_BENCH_REPS=1)
    make = envs.make

    def cut(*a, **kw):
        env = make(*a, **kw)
        return dataclasses.replace(env, ilqr=dataclasses.replace(
            env.ilqr, horizon=6, iterations=3))
    monkeypatch.setattr(envs, "make", cut)
    before = riccati.LAUNCHES
    assert perf_breakdown.main(device="cpu") == 0
    assert riccati.LAUNCHES == before       # the plain version on the CPU
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert list(line) == _json_keys("perf_breakdown.py")
    assert (line["env"], line["batch"], line["mode"], line["engine"]) == (
        "pendulum", 2, "compat", "fd")
    assert (line["horizon"], line["nv"], line["nu"], line["nefc"]) == (
        6, 2, 1, 4)
    assert line["device"] == "cpu"
    for k in ("ms_linearize", "ms_backward", "ms_rollout", "ms_linesearch",
              "ms_full_iteration", "ilqr_iters_per_s"):
        assert line[k] > 0, k
    # the Timer's table names every phase
    table = "\n".join(out[:-1])
    for name in ("linearize", "backward", "rollout_x1", "linesearch_x6",
                 "full_solve_3it"):
        assert name in table


def test_nefc_matches_jax_on_the_hopper():
    m = jenvs.make("hopper").model
    s0 = jmake_state(m)
    kin = jsmooth.kinematics(m, s0.qpos)
    con = jcollision.collide(m, kin.geom_xpos, kin.geom_xmat)
    want = jconstraint.make_efc(m, kin, s0.qpos, s0.qvel, con).J.shape[0]
    assert want == 44
    assert perf_breakdown.count_nefc(envs.make("hopper").model, "cpu") == want


def test_humanoid_balance_artifact(knobs, tmp_path, capsys):
    knobs(ILQG_HUM_FRAMES=1, ILQG_HUM_HORIZON=4, ILQG_HUM_ITERS=1)
    out = tmp_path / "hum.npz"
    assert humanoid_balance.main([str(out)], device="cpu") == 0
    z = np.load(out, allow_pickle=False)
    assert sorted(z.files) == sorted(_npz_keys())
    summary = json.loads(str(z["summary"]))
    assert list(summary) == _summary_fields()
    # what tests/test_balance_artifact.py reads
    src = TEST_BALANCE.read_text()
    for key in ("qpos", "summary", "ctrl"):
        assert f'z["{key}"]' in src and key in z.files
    assert 'summary["dt"]' in src and summary["dt"] == 0.005
    m = envs.make("humanoid").model
    assert z["qpos"].shape == (1, m.nq) and z["qvel"].shape == (1, m.nv)
    assert z["ctrl"].shape == (1, m.nu) and z["cost_trace"].shape == (1, 1)
    assert z["step_cost"].shape == (1,) and z["qpos"].dtype == np.float32
    assert summary["frames"] == 1 and summary["finite"]
    assert summary["balanced"] and summary["backend"] == "cpu"
    assert (summary["horizon"], summary["iterations"]) == (4, 1)
    assert "wrote" in capsys.readouterr().out


def test_humanoid_balance_fall_goes_to_failed(knobs, tmp_path, monkeypatch,
                                              capsys):
    knobs(ILQG_HUM_FRAMES=5, ILQG_HUM_HORIZON=2, ILQG_HUM_ITERS=1)

    def drop(env, s, sol):
        qpos = s.qpos.clone()
        qpos[:, 2] = 0.5
        return (s.replace(qpos=qpos), sol,
                (s.ctrl, torch.zeros((1, 1), dtype=s.qpos.dtype),
                 torch.zeros(1, dtype=s.qpos.dtype)))
    monkeypatch.setattr(mpc, "mpc_step", drop)
    out = tmp_path / "hum.npz"
    humanoid_balance.main([str(out)], device="cpu")
    assert not out.exists()
    z = np.load(f"{out}.failed.npz", allow_pickle=False)
    summary = json.loads(str(z["summary"]))
    assert summary["frames"] == 2 and not summary["balanced"]
    assert summary["height_min"] == 0.5
    assert "fell" in capsys.readouterr().out


def test_humanoid_balance_refuses_the_jax_artifact(knobs):
    target = ROOT / "docs" / "humanoid_balance.npz"
    existed = target.exists()
    with pytest.raises(ValueError, match="JAX package"):
        humanoid_balance.main([str(target)], device="cpu")
    assert target.exists() == existed
