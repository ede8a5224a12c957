"""PyTorch port, control-limited iLQG: boxQP against tests/test_boxqp.py's
exhaustive active-set oracle and the JAX package, and the control-limited
tassa solve on the cart-pole with a tightened ctrl range (float64, CPU).
Each test states its tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqg_mujoco_tpu.ops.boxqp import boxqp as jboxqp
from ilqg_mujoco_torch import ilqr
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops.boxqp import boxqp, first_argmin
from ilqg_mujoco_torch.physics.model import make_state
from test_boxqp import _oracle_box_min, _rand_spd
from test_torch_tassa import UMAX, _tight, solve_matches_jax

BOXQP_CASES = ["unconstrained", 1, 2, 3, 4, 5]


@pytest.mark.parametrize("case", BOXQP_CASES)
def test_boxqp_matches_oracle_and_jax(case):
    """tests/test_boxqp.py's cases: with an unbounded box one step is the
    Newton solve (rtol 1e-8); in the unit box the objective reaches the
    exhaustive active-set oracle's minimum (to 1e-8), inside the box.  The
    port's iterate equals the JAX package's to rtol 1e-10 / atol 1e-12
    (float64, another summation order)."""
    if case == "unconstrained":
        rng = np.random.default_rng(0)
        n, iters = 4, 8
        Q, g = _rand_spd(rng, n), rng.standard_normal(n)
        lo, hi = -np.full(n, 1e9), np.full(n, 1e9)
    else:
        rng = np.random.default_rng(case)
        n, iters = 3, 20
        Q, g = _rand_spd(rng, n, cond=30.0), 2.0 * rng.standard_normal(n)
        lo, hi = -np.ones(n), np.ones(n)
    t = lambda a: torch.tensor(a)[None]          # a batch of one
    out = boxqp(t(Q), t(g), t(lo), t(hi), torch.zeros(1, n), iters=iters)
    x = out.x[0].numpy()
    want = jboxqp(jnp.asarray(Q), jnp.asarray(g), jnp.asarray(lo),
                  jnp.asarray(hi), jnp.zeros(n), iters=iters)
    np.testing.assert_allclose(x, np.asarray(want.x), rtol=1e-10, atol=1e-12)
    assert out.free[0].tolist() == np.asarray(want.free).tolist()
    assert bool(out.pd[0])
    if case == "unconstrained":
        np.testing.assert_allclose(x, np.linalg.solve(Q, -g), rtol=1e-8,
                                   atol=1e-10)
        assert bool(out.free.all())
    else:
        assert np.all(x >= lo - 1e-10) and np.all(x <= hi + 1e-10)
        ref_val, _ = _oracle_box_min(Q, g, lo, hi)
        assert 0.5 * x @ Q @ x + g @ x <= ref_val + 1e-8


def test_first_argmin_matches_jnp_argmin():
    """The linesearch's selection rule: first NaN, else first of tied
    minima, as jnp.argmin."""
    v = np.array([[3.0, 1.0, 1.0, 2.0], [np.nan, 0.0, np.nan, -1.0],
                  [2.0, 2.0, 2.0, 2.0], [np.inf, 5.0, -np.inf, -np.inf],
                  [1.0, np.nan, 0.0, 0.0]])
    assert (first_argmin(torch.tensor(v)).tolist()
            == np.asarray(jnp.argmin(jnp.asarray(v), -1)).tolist()
            == [1, 0, 0, 2, 1])


def test_batched_control_limited_solve_matches_jax():
    """test_torch_tassa.py's batched solve parity (B=3, 3 iterations,
    rtol 1e-9 / atol 1e-11) with control_limits on and the tight box, so
    that boxQP clamps in the backward pass and the rollout clips."""
    solve_matches_jax(control_limits=True)


def _solve(m, cfg, s0, sol0):
    env = envs.pendulum("tassa", "ad")
    return ilqr.solve(m, env.cost_fn, s0, sol0, cfg)


def test_control_limits_off_vs_unlimited_identical():
    """With no limited actuator the boxQP path degenerates to exactly the
    unconstrained Newton solve: both solver variants agree (rtol 1e-9,
    atol 1e-12, as test_boxqp.py)."""
    env = envs.pendulum("tassa", "ad")
    m = dataclasses.replace(env.model, actuator_ctrllimited=np.array([False]))
    s0 = make_state(m, 1, device="cpu").replace(
        qpos=torch.tensor([[0.1, 0.4]], dtype=torch.float64))
    cfg_off = dataclasses.replace(env.ilqr, iterations=5)
    cfg_on = dataclasses.replace(cfg_off, control_limits=True)
    sol0 = ilqr.init_solver(m, s0, cfg_off)
    _, tr_off = _solve(m, cfg_off, s0, sol0)
    _, tr_on = _solve(m, cfg_on, s0, sol0)
    np.testing.assert_allclose(tr_on.numpy(), tr_off.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_control_limited_solve_respects_box_and_descends():
    """Tight ctrl box (|u| <= 0.35): the solve keeps every stored control
    inside the box, descends, and beats the limit-blind solver's true cost
    (recosted with the controls the plant applies)."""
    env = envs.pendulum("tassa", "ad")
    m = _tight(env.model)
    s0 = make_state(m, 1, device="cpu").replace(
        qpos=torch.tensor([[0.15, 0.6]], dtype=torch.float64))
    cfg_naive = dataclasses.replace(env.ilqr, iterations=10)
    cfg_box = dataclasses.replace(cfg_naive, control_limits=True)
    sol0 = ilqr.init_solver(m, s0, cfg_box)
    solb, trb = _solve(m, cfg_box, s0, sol0)
    assert float(solb.traj.ctrl.abs().max()) <= UMAX + 1e-8
    trb = trb[0].numpy()
    assert np.all(np.isfinite(trb)) and trb[-1] < trb[0]
    soln, _ = _solve(m, cfg_naive, s0, sol0)
    u_cl = torch.clamp(soln.traj.ctrl, -UMAX, UMAX)
    cost_naive = float(env.cost_fn(soln.traj.qpos, soln.traj.qvel,
                                   u_cl).sum())
    assert trb[-1] <= cost_naive + 1e-9, (trb[-1], cost_naive)
