"""PyTorch port, package rules: it imports neither JAX nor the JAX package,
its entry points refuse to fall back to the CPU, every env of the JAX
package's registry is ported, and states carry across as numpy."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ilqg_mujoco_torch import bench, ilqr, live_view, mpc
from ilqg_mujoco_torch.kernels import riccati
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops.linearize import LinearizeConfig
from ilqg_mujoco_torch.parallel import batch
from ilqg_mujoco_torch.physics import forward
from ilqg_mujoco_torch.physics.model import make_state
from ilqg_mujoco_torch.tools import humanoid_balance, perf_breakdown
from ilqg_mujoco_torch.utils import checkpoint, convert, frames, profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ilqg_mujoco_torch"
FORBIDDEN = ("jax", "jaxlib", "ilqg_mujoco_tpu")


def _port_modules():
    return sorted(
        "ilqg_mujoco_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                        .parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m.rstrip('.'))\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_without_device_need_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    env = envs.pendulum()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_state(env.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.init_batched(env, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpc.init(env)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_numpy(convert.to_numpy(
            make_state(env.model, 1, device="cpu")))
    ck = tmp_path / "ck.npz"
    checkpoint.save(ck, *mpc.init(dataclasses.replace(
        env, ilqr=ilqr.ILQRConfig(horizon=2, iterations=1)), device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load(ck)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frames.forward_frame(env.model, make_state(env.model))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        live_view.live_loop("pendulum", frames=1, headless=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.Timer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.device_line()
    for main in (bench.main, perf_breakdown.main,
                 lambda: humanoid_balance.main([str(tmp_path / "h.npz")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()
    assert not (tmp_path / "h.npz").exists()


def test_convert_round_trip():
    env = envs.pendulum()
    env = dataclasses.replace(env, ilqr=ilqr.ILQRConfig(horizon=3,
                                                        iterations=1))
    s = make_state(env.model, 2, device="cpu").replace(
        qpos=torch.tensor([[0.1, 0.2], [0.3, -0.4]], dtype=torch.float64))
    sol = ilqr.init_solver(env.model, s, env.ilqr)
    d = convert.to_numpy(s)
    s2 = convert.state_from_numpy(d, device="cpu")
    for f in convert.STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(s2, f)), f
    ds = convert.to_numpy(sol)
    sol2 = convert.solver_state_from_numpy(ds["traj"], ds["K"], ds["k"],
                                           ds["mu"], device="cpu")
    assert torch.equal(sol.traj.qpos, sol2.traj.qpos)
    assert torch.equal(sol.K, sol2.K) and torch.equal(sol.mu, sol2.mu)
    assert isinstance(ds["traj"]["ctrl"], np.ndarray)
    assert ds["traj"]["ctrl"].shape == (2, 4, 1)


def test_later_slices_raise():
    """Every slice up to quaternion states is ported: the tassa engines
    construct, the hopper (contacts, Euler) steps, and the tumbler and the
    humanoid construct, step and take tangent-space state differences; an
    env name the registry does not hold raises ``KeyError``."""
    ilqr.ILQRConfig(mode="tassa", lin=LinearizeConfig(engine="ad"))
    LinearizeConfig(engine="exact")
    hopper = envs.make("hopper").model
    s = forward.step(hopper, make_state(hopper, 1, device="cpu"))
    assert s.qpos.shape == (1, 6) and bool(torch.isfinite(s.qpos).all())
    for name, nq, nv in (("tumbler", 9, 8), ("humanoid", 28, 27)):
        m = envs.make(name).model
        assert (m.nq, m.nv) == (nq, nv)
        s0 = make_state(m, 1, device="cpu")
        s = forward.step(m, s0)
        assert s.qpos.shape == (1, nq) and bool(torch.isfinite(s.qpos).all())
        dx = ilqr.state_diff(m, s.qpos, s.qvel, s0.qpos, s0.qvel)
        assert dx.shape == (1, 2 * nv) and bool(torch.isfinite(dx).all())
    with pytest.raises(KeyError):
        envs.make("walker")


def test_cpu_wrapper_counts_no_launch():
    before = riccati.LAUNCHES
    Bt, N, n = 2, 3, 4
    z = lambda *s: torch.zeros(s, dtype=torch.float64)
    K, k = riccati.backward_compat_batched(
        z(Bt, N, n, n), z(Bt, N, n, 1), z(Bt, N + 1, n),
        torch.ones(Bt, N, 1, dtype=torch.float64), z(Bt, N, n), 1.0)
    assert K.shape == (Bt, N, 1, n) and riccati.LAUNCHES == before
