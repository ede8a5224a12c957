"""PyTorch port, the slice as a whole: the compat+FD iLQR solve and the
closed MPC loop on the cart-pole, against the JAX package and the MuJoCo C
core oracle (tools/golden_ref.py), float64 on the CPU.

Tolerances are those of tests/test_golden_compat.py: cost trace rtol 1e-5,
controls rtol 1e-4 / atol 1e-7, trajectory rtol 1e-5 / atol 1e-8, gains
rtol 1e-3 / atol 1e-6.  eps=1e-6 central differences amplify last-bit
differences between two physics cores, so the solves agree to what FD noise
allows, not bit for bit."""

import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from ilqg_mujoco_tpu import mpc as jmpc
from ilqg_mujoco_tpu.models import envs as jenvs
from ilqg_mujoco_tpu.ops.linearize import LinearizeConfig as JLinCfg
from ilqg_mujoco_torch import ilqr, mpc
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops.linearize import LinearizeConfig
from ilqg_mujoco_torch.parallel import batch
from ilqg_mujoco_torch.utils.convert import (solver_state_from_numpy,
                                             state_from_numpy)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ASSET = ROOT / "ilqg_mujoco_tpu" / "models" / "assets" / "cartpole.xml"
MPC_FRAMES = 3


def _golden_env(horizon=20):
    """The reference's exact configuration: compat mode, fd engine, the
    transposed-A quirk."""
    env = envs.pendulum()
    return dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, horizon=horizon,
        lin=LinearizeConfig(compat_transpose_A=True)))


def _jax_golden_env():
    env = jenvs.pendulum(mode="compat", engine="fd")
    return dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, lin=JLinCfg(engine="fd", compat_transpose_A=True)))


def _jnp(x):
    return {f.name: np.asarray(getattr(x, f.name))[None]
            for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def jax_frames():
    """1 + MPC_FRAMES JAX MPC frames from mpc.init in one compiled scan:
    frame 0's solve is the golden solve, frames 1.. the closed loop."""
    env = _jax_golden_env()
    s0, sol0 = jmpc.init(env)

    def frame(carry, _):
        s, so = carry
        s2, so2, (u0, trace, _) = jmpc.mpc_step(env, s, so)
        return (s2, so2), (s, so2, u0, trace)

    _, (states, sols, us, traces) = jax.jit(lambda s, so: jax.lax.scan(
        frame, (s, so), None, length=1 + MPC_FRAMES))(s0, sol0)
    at = lambda tree, i: jax.tree_util.tree_map(lambda a: a[i], tree)
    return dict(s0=s0, sol=at(sols, 0), trace=np.asarray(traces[0]),
                s1=at(states, 1), qpos=np.asarray(states.qpos[1:]),
                ctrl=np.asarray(us[1:]), traces=np.asarray(traces[1:]))


@pytest.fixture(scope="module")
def port_solve():
    env = _golden_env()
    s0, sol0 = mpc.init(env, device="cpu")
    sol, trace = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    return s0, sol, trace[0].numpy()


@pytest.fixture(scope="module")
def golden():
    pytest.importorskip("mujoco")
    sys.path.insert(0, str(ROOT))
    from tools import golden_ref
    return golden_ref.run_pendulum_golden(ASSET, iterations=10)


def _assert_solve_matches(sol, trace, ref):
    np.testing.assert_allclose(trace, ref["trace"], rtol=1e-5)
    np.testing.assert_allclose(sol.traj.ctrl[0].numpy(), ref["ctrl"],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(sol.traj.qpos[0].numpy(), ref["qpos"],
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(sol.K[0].numpy(), ref["K"], rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(sol.k[0].numpy(), ref["k"], rtol=1e-3,
                               atol=1e-6)


def test_solve_matches_jax(port_solve, jax_frames):
    s0, sol, trace = port_solve
    np.testing.assert_allclose(s0.qpos[0].numpy(),
                               np.asarray(jax_frames["s0"].qpos), atol=1e-12)
    np.testing.assert_allclose(s0.qvel[0].numpy(),
                               np.asarray(jax_frames["s0"].qvel), atol=1e-12)
    js = jax_frames["sol"]
    _assert_solve_matches(sol, trace, dict(
        trace=jax_frames["trace"], ctrl=np.asarray(js.traj.ctrl),
        qpos=np.asarray(js.traj.qpos), K=np.asarray(js.K),
        k=np.asarray(js.k)))


def test_solve_matches_golden_reference(port_solve, golden):
    s0, sol, trace = port_solve
    np.testing.assert_allclose(s0.qpos[0].numpy(), golden["x0_qpos"],
                               atol=1e-12)
    _assert_solve_matches(sol, trace, golden)


def test_closed_loop_frames_match_jax(jax_frames):
    """MPC frames 1..3 starting from the JAX package's env and solver state
    after frame 0, carried over as numpy."""
    env = _golden_env()
    s = state_from_numpy(_jnp(jax_frames["s1"]), device="cpu")
    js = jax_frames["sol"]
    sol = solver_state_from_numpy(_jnp(js.traj), np.asarray(js.K)[None],
                                  np.asarray(js.k)[None],
                                  np.asarray(js.mu)[None], device="cpu")
    qpos, ctrl, traces = [], [], []
    for _ in range(MPC_FRAMES):
        qpos.append(s.qpos[0].numpy())
        s, sol, (u0, trace, _) = mpc.mpc_step(env, s, sol)
        ctrl.append(u0[0].numpy())
        traces.append(trace[0].numpy())
    np.testing.assert_allclose(np.array(qpos), jax_frames["qpos"],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.array(ctrl), jax_frames["ctrl"],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.array(traces), jax_frames["traces"],
                               rtol=1e-5)


def test_batched_solve_equals_single_instances():
    """A diverse B=3 batch through make_batched_solve gives each instance
    what it gets alone.  The per-instance early-exit mask of the constraint
    solver makes the arithmetic identical; the tolerance only allows the
    batched matrix products another summation order (rtol 1e-9, amplified
    by FD as above)."""
    env = envs.pendulum()
    env = dataclasses.replace(env, ilqr=dataclasses.replace(env.ilqr,
                                                            iterations=2))
    # the third instance lies against the hinge limit, where the constraint
    # solver needs more iterations than for the other two
    noise = np.array([[0.05, 0.1], [-0.3, 0.5], [0.98, 1.55]])
    states, sols = batch.init_batched(env, 3, qpos_noise=1.0, noise=noise,
                                      device="cpu")
    solve = batch.make_batched_solve(env)
    sol_b, trace_b = solve(states, sols)
    for i in range(3):
        one = lambda x: x[i:i + 1]
        sol_1, trace_1 = solve(states.map(one), ilqr.ILQRState(
            sols.traj.map(one), one(sols.K), one(sols.k), one(sols.mu)))
        np.testing.assert_allclose(trace_b[i:i + 1].numpy(), trace_1.numpy(),
                                   rtol=1e-9)
        for a, b in ((sol_b.traj.qpos, sol_1.traj.qpos),
                     (sol_b.traj.ctrl, sol_1.traj.ctrl),
                     (sol_b.K, sol_1.K), (sol_b.k, sol_1.k)):
            np.testing.assert_allclose(a[i:i + 1].numpy(), b.numpy(),
                                       rtol=1e-9, atol=1e-12)


def test_batched_mpc_step_runs_every_instance():
    env = envs.pendulum()
    env = dataclasses.replace(env, ilqr=dataclasses.replace(env.ilqr,
                                                            iterations=1))
    states, sols = batch.init_batched(
        env, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    step = batch.make_batched_mpc_step(env)
    s2, sol2, cost = step(states, sols)
    assert cost.shape == (2,) and bool(torch.isfinite(cost).all())
    assert bool((s2.time > states.time).all())
    assert sol2.traj.qpos.shape == (2, 21, 2)


@pytest.mark.slow
def test_closed_loop_50_frames_matches_golden_reference():
    """The reference's product, InvertedPendulum::forward() driven from the
    render loop, for 50 frames through mpc.run.  The oracle's ILQR object
    has already run the initial 10-iteration solve when the loop starts, so
    the loop resumes from the solved state."""
    pytest.importorskip("mujoco")
    sys.path.insert(0, str(ROOT))
    from tools import golden_ref
    golden = golden_ref.run_pendulum_golden(ASSET, iterations=10,
                                            mpc_frames=50)
    env = _golden_env()
    s0, sol0 = mpc.init(env, device="cpu")
    sol, _ = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    out = mpc.run(env, 50, x0=s0, sol0=sol)
    np.testing.assert_allclose(out.env_states.qpos[0].numpy(),
                               golden["mpc_qpos"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(out.controls[0].numpy(), golden["mpc_ctrl"],
                               rtol=1e-4, atol=1e-7)


@pytest.mark.slow
def test_long_horizon_T100_matches_golden_reference():
    """Horizon 100: the reference recursion diverges on both sides; the
    stable early iterations match tightly, the diverged tail to what FD
    noise amplification allows (as tests/test_golden_compat.py)."""
    pytest.importorskip("mujoco")
    sys.path.insert(0, str(ROOT))
    from tools import golden_ref
    golden = golden_ref.run_pendulum_golden(ASSET, iterations=10, N=100)
    env = _golden_env(horizon=100)
    s0, sol0 = mpc.init(env, device="cpu")
    _, trace = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    trace = trace[0].numpy()
    np.testing.assert_allclose(trace[:5], golden["trace"][:5], rtol=1e-4)
    np.testing.assert_allclose(trace, golden["trace"], rtol=5e-3)
    assert trace[-1] > 1e6
