"""PyTorch port, the tumbler (a free joint and 2 hinges: nq 9, nv 8, nu 2;
no gravity, no contacts) against the JAX package and the MuJoCo C core
(float64, CPU): quaternion states end to end, from the loader through
``state_diff``, the tassa backward pass and the linesearch to MPC.

States come from tests/test_tumbler.py's tilted start (a tilted base at
rest, the arm deflected and spinning) and reach both packages as numpy
arrays.  Tolerances:

* the loader field by field, exactly: both packages run the same numpy
  loader on byte-identical assets;
* 200 Euler steps against the C core at rtol 1e-9 / atol 1e-10 and FD
  against AD within the port at rtol 1e-4 (atol 1e-5 on A and B, 1e-4 on
  gx): tests/test_tumbler.py's tolerances;
* the exact engine against central differences of the step in tangent
  coordinates at rtol 1e-6 / atol 1e-7;
* the cost quadratics, the linearization and the tassa solve against the
  JAX package at rtol 1e-9 (atol 1e-9 of each array's largest entry), with
  the same alpha selected at every iteration: exact derivatives of two
  physics cores that agree to ~1e-15;
* MPC frames keep every quaternion's norm within 1e-9 of 1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from ilqg_mujoco_tpu import ilqr as jilqr  # noqa: E402
from ilqg_mujoco_tpu.models import envs as jenvs  # noqa: E402
from ilqg_mujoco_tpu.ops.linearize import (  # noqa: E402
    linearize_traj as jlinearize)
from ilqg_mujoco_tpu.physics import mjcf as jmjcf  # noqa: E402
from ilqg_mujoco_tpu.physics.model import State as JState  # noqa: E402
from ilqg_mujoco_torch import ilqr, mpc  # noqa: E402
from ilqg_mujoco_torch.models import envs  # noqa: E402
from ilqg_mujoco_torch.ops.linearize import (LinearizeConfig,  # noqa: E402
                                             _qpos_diff, linearize_ad,
                                             linearize_exact, linearize_fd,
                                             linearize_traj)
from ilqg_mujoco_torch.physics import forward as fwd  # noqa: E402
from ilqg_mujoco_torch.physics.model import make_state  # noqa: E402
from ilqg_mujoco_torch.utils.convert import to_numpy  # noqa: E402

ASSET = envs.ASSETS / "tumbler.xml"
JAX_ASSET = envs.ASSETS.parents[2] / "ilqg_mujoco_tpu" / "models" / \
    "assets" / "tumbler.xml"
B = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tilted(batch=1, seed=None):
    """tests/test_tumbler.py's state: a tilted quaternion, the arm
    deflected and spinning, the base at rest (zero angular momentum, so
    the attitude task is reachable).  With ``seed`` every instance after
    the first gets seeded noise on qpos and on the arm's rates."""
    quat = np.array([np.cos(0.15), np.sin(0.15) * 0.6, np.sin(0.15) * 0.8,
                     0.0])
    quat /= np.linalg.norm(quat)
    qpos = np.repeat(np.concatenate([[0.0, 0.0, 1.0], quat, [0.6, -0.5]])[
        None], batch, 0)
    qvel = np.repeat(np.array([0.0] * 6 + [2.0, -1.5])[None], batch, 0)
    if seed is not None:
        rng = np.random.default_rng(seed)
        qpos[1:] += 0.05 * rng.standard_normal((batch - 1, 9))
        qvel[1:, 6:] += 0.5 * rng.standard_normal((batch - 1, 2))
    return qpos, qvel


def _state(qpos, qvel):
    m = envs.make("tumbler").model
    return make_state(m, len(qpos), device="cpu").replace(
        qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max(), err_msg=what)


def test_loader_matches_jax():
    assert ASSET.read_bytes() == JAX_ASSET.read_bytes()
    jm, tm = jmjcf.load_model(str(JAX_ASSET)), envs.make("tumbler").model
    assert (tm.nq, tm.nv, tm.nu) == (9, 8, 2)
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "opt":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(jm.dof_mask, tm.dof_mask)


def test_physics_matches_mujoco():
    """200 Euler steps of free-joint (quaternion-integrating) dynamics
    under sinusoidal ctrl, state by state against the C core."""
    mm = mujoco.MjModel.from_xml_path(str(ASSET))
    md = mujoco.MjData(mm)
    qpos, qvel = _tilted()
    md.qpos[:], md.qvel[:] = qpos[0], qvel[0]
    m = envs.make("tumbler").model
    s = _state(qpos, qvel)
    for i in range(200):
        u = np.array([0.8 * np.sin(0.1 * i), -0.5 * np.cos(0.07 * i)])
        md.ctrl[:] = u
        s = fwd.step(m, s.replace(ctrl=torch.tensor(u)[None]))
        mujoco.mj_step(mm, md)
        np.testing.assert_allclose(s.qpos[0].numpy(), md.qpos, rtol=1e-9,
                                   atol=1e-10, err_msg=f"qpos, step {i}")
        np.testing.assert_allclose(s.qvel[0].numpy(), md.qvel, rtol=1e-9,
                                   atol=1e-10, err_msg=f"qvel, step {i}")


def test_fd_matches_ad():
    """Tangent-space FD (quaternion-aware perturbations) agrees with AD at
    the tilted state."""
    env = envs.make("tumbler")
    s = _state(*_tilted())
    fd = linearize_fd(env.model, s, env.cost_fn, LinearizeConfig())
    ad = linearize_ad(env.model, s, env.cost_fn, LinearizeConfig())
    for f, atol in (("A", 1e-5), ("B", 1e-5), ("gx", 1e-4)):
        torch.testing.assert_close(getattr(fd, f), getattr(ad, f), rtol=1e-4,
                                   atol=atol)


def test_exact_engine_matches_tangent_fd():
    """linearize_exact's A and B against central differences of the full
    step in tangent coordinates (qpos moved by integrate_pos, the next
    state compared by the quaternion log map), eps 1e-6, rtol 1e-6 / atol
    1e-7: the FD's truncation and rounding.  The JAX package's exact
    engine zeroes the rotation rows here (its log map has a zero
    derivative at a zero rotation); the port does not copy that."""
    env = envs.make("tumbler")
    m, nv, nu, eps = env.model, env.model.nv, env.model.nu, 1e-6
    qpos, qvel = _tilted()
    qvel[0, :6] = [0.1, 0.2, 0.0, 0.3, -0.2, 0.1]
    s = _state(qpos, qvel)
    ex = linearize_exact(m, s, env.cost_fn, LinearizeConfig(engine="exact"))
    s1 = fwd.step(m, s)
    cols = []
    for i in range(2 * nv + nu):
        d = torch.zeros(2 * nv + nu, dtype=torch.float64)
        d[i] = eps
        nxt = []
        for sg in (1.0, -1.0):
            st = s.replace(
                qpos=fwd.integrate_pos(m, s.qpos, sg * d[:nv][None], 1.0),
                qvel=s.qvel + sg * d[nv:2 * nv], ctrl=s.ctrl + sg * d[2 * nv:])
            s2 = fwd.step(m, st)
            nxt.append(torch.cat([_qpos_diff(m, s2.qpos, s1.qpos),
                                  s2.qvel - s1.qvel], -1)[0])
        cols.append((nxt[0] - nxt[1]) / (2 * eps))
    J = torch.stack(cols, -1)
    torch.testing.assert_close(ex.A[0], J[:, :2 * nv], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ex.B[0], J[:, 2 * nv:], rtol=1e-6, atol=1e-7)


def _jtree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _jsol(sol):
    return jilqr.ILQRState(JState(**_jtree(to_numpy(sol.traj))),
                           jnp.asarray(sol.K.numpy()),
                           jnp.asarray(sol.k.numpy()),
                           jnp.asarray(sol.mu.numpy()))


@pytest.fixture(scope="module")
def setup():
    """Two tilted instances, their initial solver states, and the JAX
    package's linearization and iterate_tassa up to the selection, each
    vmapped over the instances and compiled once."""
    env = envs.make("tumbler")
    x0 = _state(*_tilted(B, seed=3))
    sol0 = ilqr.init_solver(env.model, x0, env.ilqr)
    jenv = jenvs.make("tumbler")
    jm, cost, jcfg = jenv.model, jenv.cost_fn, jenv.ilqr

    def rollouts(x, so, lin):
        """iterate_tassa (ilqg_mujoco_tpu/ilqr.py) up to the selection."""
        K, k, _, _, ok = jilqr.backward_pass_tassa(jm, so.traj, lin, cost,
                                                   so.mu, jcfg)
        cand = jilqr.ILQRState(traj=so.traj, K=K, k=k, mu=so.mu)
        alphas = jnp.concatenate([jnp.zeros((1,), k.dtype),
                                  jnp.asarray(jcfg.alphas, k.dtype)])
        trajs = jax.vmap(lambda a: jilqr.forward_pass(jm, x, cand, jcfg,
                                                      alpha=a))(alphas)
        costs = jax.vmap(lambda t: jilqr._traj_cost(cost, t))(trajs)
        return K, k, ok, trajs, costs, jilqr._traj_cost(cost, so.traj)

    linearize = jax.jit(jax.vmap(
        lambda so: jlinearize(jm, so.traj, cost, jcfg.lin)))
    quadratics = jax.jit(jax.vmap(
        lambda t: jilqr._cost_quadratics(cost, jm, t)))
    return (env, x0, sol0, linearize, jax.jit(jax.vmap(rollouts)), jcfg,
            quadratics)


def _jax_select(sol, out, cfg):
    """iterate_tassa's selection, per instance, in numpy: returns (the
    next JAX solver state, cost, selected index into (0,) + alphas, -1 for
    keeping the stored trajectory)."""
    K, k, ok, trajs, costs, stale = out
    costs, stale, ok = np.asarray(costs), np.asarray(stale), np.asarray(ok)
    mu = np.asarray(sol.mu)
    rebase_ok = np.isfinite(costs[:, 0])
    cost0 = np.where(rebase_ok, costs[:, 0], stale)
    best = np.argmin(costs[:, 1:], axis=1) + 1     # jnp.argmin's rule
    cbest = costs[np.arange(B), best]
    improved = ok & (cbest < cost0)
    sel = np.where(improved, best, np.where(rebase_ok, 0, -1))
    fields = {}
    for f in dataclasses.fields(JState):
        cand = np.asarray(getattr(trajs, f.name))
        old = np.asarray(getattr(sol.traj, f.name))
        fields[f.name] = jnp.asarray(np.stack([
            cand[b, sel[b]] if sel[b] >= 0 else old[b] for b in range(B)]))
    mu = np.where(improved, np.maximum(mu / cfg.mu_factor, cfg.mu_min),
                  np.minimum(mu * cfg.mu_factor ** 2, cfg.mu_max))
    new = jilqr.ILQRState(JState(**fields), K, k, jnp.asarray(mu))
    return new, np.where(improved, cbest, cost0), sel


def test_cost_quadratics_and_linearization_match_jax(setup):
    """The exact cost expansion (torch.func.hessian through
    integrate_pos) and linearize_ad on the initial trajectories."""
    env, _, sol0, jlin, _, _, jquad = setup
    m = env.model
    got = ilqr._cost_quadratics(env.cost_fn, m, sol0.traj)
    want = jquad(_jsol(sol0).traj)
    for name, g, w in zip(("lx", "lu", "lxx", "luu", "lux"), got, want):
        _close(g.numpy(), w, name)
    lin = linearize_traj(m, sol0.traj, env.cost_fn, env.ilqr.lin)
    jl = jlin(_jsol(sol0))
    for f in lin._fields:
        _close(getattr(lin, f).numpy(), getattr(jl, f), f)


def test_tassa_solve_matches_jax_alpha_by_alpha(setup):
    """The tumbler's full tassa+ad solve (N=20, 8 iterations) on both
    packages, each carrying its own solver state: the same alpha selected
    for every instance at every iteration, and the costs, mu, gains and
    controls matching; the port's ilqr.solve gives the same trace as its
    part-by-part loop, finite, monotone and below 0.9 of the initial
    rollout's cost (tests/test_tumbler.py's bar)."""
    env, x0, sol0, jlin, jrollouts, jcfg, _ = setup
    m, cfg, cost_fn = env.model, env.ilqr, env.cost_fn
    jx0 = JState(**_jtree(to_numpy(x0)))
    sol, jsol, sels, trace = sol0, _jsol(sol0), [], []
    for _ in range(cfg.iterations):
        lin = linearize_traj(m, sol.traj, cost_fn, cfg.lin)
        K, k, _, _, ok = ilqr.backward_pass_tassa(m, sol.traj, lin, cost_fn,
                                                  sol.mu, cfg)
        trajs, costs = ilqr.linesearch_rollouts(m, cost_fn, x0, sol, K, k,
                                                cfg)
        sol, cost, sel = ilqr.linesearch_select(cost_fn, sol, K, k, ok,
                                                trajs, costs, cfg)
        jsol, jcost, jsel = _jax_select(
            jsol, jrollouts(jx0, jsol, jlin(jsol)), jcfg)
        assert sel.tolist() == jsel.tolist()
        _close(cost.numpy(), jcost, "cost")
        np.testing.assert_allclose(sol.mu.numpy(), np.asarray(jsol.mu),
                                   rtol=1e-12)
        _close(sol.K.numpy(), jsol.K, "K")
        _close(sol.k.numpy(), jsol.k, "k")
        _close(sol.traj.ctrl.numpy(), jsol.traj.ctrl, "ctrl")
        _close(sol.traj.qpos.numpy(), jsol.traj.qpos, "qpos")
        sels.append(sel)
        trace.append(cost)
    assert any(bool((s > 0).any()) for s in sels)    # some step accepted
    _, trace_b = ilqr.solve(m, cost_fn, x0, sol0, cfg)
    trace = torch.stack(trace, 1)
    np.testing.assert_allclose(trace_b.numpy(), trace.numpy(), rtol=1e-12)
    assert bool(torch.isfinite(trace).all())
    assert bool((trace.diff(dim=1) <= 1e-9).all())
    cost0 = ilqr._traj_cost(cost_fn, sol0.traj)
    assert bool((trace[:, -1] < 0.9 * cost0).all()), (trace, cost0)


def test_mpc_frames_keep_unit_quaternions():
    """Six receding-horizon MPC frames from the tilted start: finite
    states and controls, unit quaternions, and a lower step cost at the
    end than at the start (tests/test_tumbler.py::test_tumbler_mpc_frames)."""
    env = envs.make("tumbler")
    out = mpc.run(env, 6, _state(*_tilted()))
    qpos = out.env_states.qpos[0]
    assert bool(torch.isfinite(qpos).all())
    assert bool(torch.isfinite(out.controls).all())
    norms = qpos[:, 3:7].norm(dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, rtol=0, atol=1e-9)
    costs = out.step_cost[0]
    assert float(costs[-1]) < float(costs[0])
