"""PyTorch port, the scaled value recursion (``value_scaling``) through
contact: the counterpart of
tests/test_value_scaling.py::test_scaled_equals_plain_f64_hopper_contact.

On a hopper horizon in contact (300 steps from rest, then N=40) the scaled
``backward_pass_tassa`` must equal the plain one at that test's
tolerances: K rtol 1e-7 (atol 1e-7 of the largest |K|), k rtol 1e-7 (atol
1e-9 (1 + max|k|)), dV1 and dV2 rtol 1e-6, and the same positive-
definiteness flag.  The scaled recursion is exact in infinite precision,
and its dtype-relative regulariser floor lies below float64's resolution
of the ratios involved."""

import dataclasses

import pytest
import torch

from ilqg_mujoco_torch import ilqr
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops.linearize import linearize_traj
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics.model import make_state

MU = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scaled_equals_plain_f64_hopper_contact():
    env = envs.make("hopper")
    m = env.model
    s = make_state(m, 1, device="cpu")
    for _ in range(300):
        s = fwd.step(m, s)
    cfg = dataclasses.replace(env.ilqr, horizon=40, iterations=1)
    sol = ilqr.init_solver(m, s, cfg)
    _, aux = fwd.forward_full(m, sol.traj)
    assert bool((aux.efc.D[..., 6:] > 0).any())      # in contact
    lin = linearize_traj(m, sol.traj, env.cost_fn, cfg.lin)
    mu = torch.full((1,), MU, dtype=torch.float64)
    K, k, dV1, dV2, ok = ilqr.backward_pass_tassa(
        m, sol.traj, lin, env.cost_fn, mu, cfg)
    Ks, ks, dV1s, dV2s, oks = ilqr.backward_pass_tassa(
        m, sol.traj, lin, env.cost_fn, mu,
        dataclasses.replace(cfg, value_scaling=True))
    torch.testing.assert_close(Ks, K, rtol=1e-7,
                               atol=1e-7 * float(K.abs().max()))
    torch.testing.assert_close(ks, k, rtol=1e-7,
                               atol=1e-9 * (1 + float(k.abs().max())))
    torch.testing.assert_close(dV1s, dV1, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(dV2s, dV2, rtol=1e-6, atol=0.0)
    assert torch.equal(ok, oks)
