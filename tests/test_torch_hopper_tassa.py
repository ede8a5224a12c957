"""PyTorch port, the hopper's tassa+ad path against the JAX package
(float64, CPU): linearize_ad through contact, where the constraint
Jacobian's derivative dJ is non-zero, and the batched tassa solve
iteration by iteration, with the same linesearch alpha at every one.

Two JAX compiles serve the file: the vmapped linearization of a
trajectory, and the rest of the JAX package's ``iterate_tassa`` up to the
selection (backward pass, alpha rollouts, costs); the selection itself,
which the test needs to see, follows ``iterate_tassa`` in numpy.  States come
from a C-core warm-in (``mujoco.mj_step``, 100 steps: the hopper stands on
its foot) with seeded perturbations, and reach both packages as numpy
arrays.  Tolerance rtol 1e-9 on the linearization and on traces, gains and
controls (atol 1e-9 of each array's largest entry, for entries near
zero): exact derivatives of two physics cores that agree to ~1e-15, so no
FD noise amplifies the last-bit differences."""

import dataclasses
import pathlib

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
from ilqg_mujoco_tpu.physics.model import State as JState  # noqa: E402
from ilqg_mujoco_torch import ilqr, mpc  # noqa: E402
from ilqg_mujoco_torch.models import envs  # noqa: E402
from ilqg_mujoco_torch.ops.linearize import linearize_traj  # noqa: E402
from ilqg_mujoco_torch.physics import forward as fwd  # noqa: E402
from ilqg_mujoco_torch.utils.convert import (state_from_numpy,  # noqa: E402
                                             to_numpy)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ASSET = ROOT / "ilqg_mujoco_tpu" / "models" / "assets" / "hopper.xml"
N, ITERS, B = 8, 3, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max(), err_msg=what)


def _jtree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def setup():
    """Two perturbed C-core states after 100 steps, their initial solver
    states, and the JAX iteration (compiled once)."""
    env = envs.make("hopper")
    env = dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, horizon=N, iterations=ITERS))
    mm = mujoco.MjModel.from_xml_path(str(ASSET))
    md = mujoco.MjData(mm)
    for _ in range(100):
        mujoco.mj_step(mm, md)
    rng = np.random.default_rng(11)
    d = {f: np.repeat(np.asarray(getattr(md, f))[None], B, 0)
         for f in ("qpos", "qvel", "qacc", "qacc_warmstart", "qfrc_applied",
                   "xfrc_applied", "ctrl")}
    d["time"] = np.full(B, md.time)
    d["qpos"] = d["qpos"] + 0.003 * rng.standard_normal((B, 6))
    d["ctrl"] = rng.uniform(-0.5, 0.5, (B, 3))
    x0 = state_from_numpy(d, device="cpu")
    sol0 = ilqr.init_solver(env.model, x0, env.ilqr)

    jenv = jenvs.make("hopper")
    jcfg = dataclasses.replace(jenv.ilqr, horizon=N, iterations=ITERS)
    jm, cost = jenv.model, jenv.cost_fn

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
    return env, x0, sol0, linearize, jax.jit(jax.vmap(rollouts)), jcfg


def _jsol(sol):
    return jilqr.ILQRState(JState(**_jtree(to_numpy(sol.traj))),
                           jnp.asarray(sol.K.numpy()),
                           jnp.asarray(sol.k.numpy()),
                           jnp.asarray(sol.mu.numpy()))


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


def test_linearize_ad_matches_jax_through_contact(setup):
    env, _, sol0, jlin, _, _ = setup
    m = env.model
    # the trajectory is in contact at every knot, so J moves with qpos
    _, aux = fwd.forward_full(m, sol0.traj)
    assert bool((aux.efc.D[..., 6:] > 0).any(-1).all())
    got = linearize_traj(m, sol0.traj, env.cost_fn, env.ilqr.lin)
    want = jlin(_jsol(sol0))
    for f in got._fields:
        _close(getattr(got, f).numpy(), getattr(want, f), f)


def test_tassa_solve_matches_jax_alpha_by_alpha(setup):
    """Three iterations of the batched tassa solve on both packages, each
    carrying its own solver state: the same alpha selected for every
    instance at every iteration, and the costs, mu, gains and controls
    matching; the port's solve through make_batched_solve gives the same
    trace and controls as its part-by-part loop."""
    env, x0, sol0, jlin, jrollouts, jcfg = setup
    m, cfg, cost_fn = env.model, env.ilqr, env.cost_fn
    jx0 = JState(**_jtree(to_numpy(x0)))
    sol, jsol, sels, trace = sol0, _jsol(sol0), [], []
    for _ in range(ITERS):
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
        sels.append(sel)
        trace.append(cost)
    assert any(bool((s > 0).any()) for s in sels)    # some step accepted
    sol_b, trace_b = ilqr.solve(m, cost_fn, x0, sol0, cfg)
    np.testing.assert_allclose(trace_b.numpy(), torch.stack(trace, 1).numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(sol_b.traj.ctrl.numpy(), sol.traj.ctrl.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_tassa_mpc_rebases_through_contact(setup):
    """Under MPC the stored trajectory is rebased onto the alpha=0 rollout
    from the current state, also with the hopper on the floor
    (tests/test_ilqr.py::test_tassa_mpc_rebases_on_state_drift)."""
    env, x0, sol0 = setup[:3]
    m, cfg = env.model, dataclasses.replace(env.ilqr, iterations=2)
    env = dataclasses.replace(env, ilqr=cfg)
    sol1, tr1 = ilqr.solve(m, env.cost_fn, x0, sol0, cfg)
    # pitched forward and moving backwards: worse than any stored knot
    s_bad = x0.replace(qpos=x0.qpos + torch.tensor([0.0, 0, 0.2, 0, 0, 0]),
                       qvel=x0.qvel - 1.0)
    s2, sol2, (u0, trace2, _) = mpc.mpc_step(env, s_bad, sol1)
    assert torch.equal(sol2.traj.qpos[:, 0], s_bad.qpos)
    assert bool((trace2[:, 0] > tr1[:, -1]).all())
    assert bool(torch.isfinite(u0).all()) and bool(
        torch.isfinite(s2.qpos).all())
    assert bool((trace2.diff(dim=1) <= 1e-9).all())
