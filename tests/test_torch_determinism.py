"""PyTorch port, bitwise determinism on the CPU: the counterparts of
tests/test_determinism.py.  The same inputs through the same code must
give the same bits, run after run: a cart-pole compat solve (trace,
trajectory, K and k; N=10, 5 iterations), and a hopper contact step after
300 steps from rest (qpos, qvel, qacc).  ``chip_smoke.py`` checks the same
on the card."""

import dataclasses

import pytest
import torch

from ilqg_mujoco_torch import ilqr, mpc
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics.model import make_state


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_solve_bitwise_deterministic():
    env = envs.pendulum()
    env = dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, horizon=10, iterations=5))
    s0, sol0 = mpc.init(env, device="cpu")
    sol1, t1 = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    sol2, t2 = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    assert torch.equal(t1, t2)
    assert torch.equal(sol1.traj.qpos, sol2.traj.qpos)
    assert torch.equal(sol1.traj.ctrl, sol2.traj.ctrl)
    assert torch.equal(sol1.K, sol2.K)
    assert torch.equal(sol1.k, sol2.k)


def test_contact_step_bitwise_deterministic():
    m = envs.make("hopper").model
    s = make_state(m, 1, device="cpu")
    for _ in range(300):
        s = fwd.step(m, s)
    a, b = fwd.step(m, s), fwd.step(m, s)
    assert torch.equal(a.qpos, b.qpos)
    assert torch.equal(a.qvel, b.qvel)
    assert torch.equal(a.qacc, b.qacc)
