"""PyTorch port, FD linearizer: a 21-knot cart-pole trajectory batch through
the JAX package's ``linearize_traj`` and the port's (float64, CPU).

Tolerance for A, B, gx, gu: rtol 1e-6, atol 1e-8.  The two physics cores
agree to ~1e-15 (tests/test_torch_physics.py); central differences with
eps=1e-6 divide that by 2e-6, and the pinned 30-iteration CG carries it on,
so ~1e-9 relative is what last-bit differences leave."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqg_mujoco_tpu.models import envs as jenvs
from ilqg_mujoco_tpu.ops.linearize import LinearizeConfig as JLinCfg
from ilqg_mujoco_tpu.ops.linearize import linearize_traj as jlinearize_traj
from ilqg_mujoco_tpu.physics.model import State as JState
from ilqg_mujoco_torch import ilqr
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops.linearize import (LinearizeConfig, _center,
                                             linearize_fd, linearize_traj,
                                             scramble_B)
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics.model import make_state
from ilqg_mujoco_torch.utils.convert import to_numpy


@pytest.fixture(scope="module")
def traj():
    """Two instances rolled out 20 steps under constant ctrl; the second
    starts against both joint limits so limit rows are active on some
    knots."""
    env = envs.pendulum()
    s = make_state(env.model, 2, device="cpu").replace(
        qpos=torch.tensor([[0.05, 0.2], [0.95, 1.5]], dtype=torch.float64),
        qvel=torch.tensor([[0.1, -0.3], [0.5, 1.0]], dtype=torch.float64),
        ctrl=torch.tensor([[0.5], [2.5]], dtype=torch.float64))
    return env, ilqr.init_solver(env.model, s, env.ilqr).traj


def _jax_states(t):
    return JState(**{k: jnp.asarray(v) for k, v in to_numpy(t).items()})


def test_linearize_traj_matches_jax(traj):
    env, t = traj
    got = linearize_traj(env.model, t, env.cost_fn, env.ilqr.lin)
    jenv = jenvs.pendulum()
    want = jax.jit(jax.vmap(lambda s: jlinearize_traj(
        jenv.model, s, jenv.cost_fn, JLinCfg())))(_jax_states(t))
    assert got.A.shape == (2, 21, 4, 4) and got.B.shape == (2, 21, 4, 1)
    for name in ("A", "B", "gx", "gu"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-12)


def test_compat_transpose_flag(traj):
    """compat_transpose_A reproduces the reference's transposed lower
    blocks (SURVEY.md §7.0.1); B is identical for nu=1."""
    env, t = traj
    nv = env.model.nv
    a = linearize_fd(env.model, t, env.cost_fn,
                     LinearizeConfig(compat_transpose_A=False))
    b = linearize_fd(env.model, t, env.cost_fn,
                     LinearizeConfig(compat_transpose_A=True))
    np.testing.assert_allclose(a.A[..., nv:, :nv].numpy(),
                               b.A[..., nv:, :nv].transpose(-1, -2).numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(a.B.numpy(), b.B.numpy(), rtol=1e-12)


def test_center_warmup_skip_equivalence(traj):
    """The center (one full forward + nwarmup-1 acc-stage-only solves) is
    bit-identical to nwarmup full forwards: the warmup never changes qpos
    or qvel."""
    env, t = traj
    cfg = LinearizeConfig(nwarmup=3)
    got = _center(env.model, t, cfg)
    full = t
    for _ in range(cfg.nwarmup):
        full = fwd.forward(env.model, full, iterations=cfg.niter,
                           tolerance=0.0)
    np.testing.assert_array_equal(got.qacc.numpy(), full.qacc.numpy())
    np.testing.assert_array_equal(got.qacc_warmstart.numpy(),
                                  full.qacc_warmstart.numpy())


def test_scramble_B_matches_c_buffer_semantics():
    """The reference's ctrl-Jacobian layout bug, simulated on the flat
    buffer: written deriv[i + j*nu] = Ju[j, i] (src/mjderivative.cpp:107),
    read column-major (inc/differentiator.h:22,59)."""
    rng = np.random.default_rng(0)
    for nv, nu in [(6, 3), (5, 2), (4, 1)]:
        Ju = rng.standard_normal((nv, nu))
        flat = np.zeros(nv * nu)
        for i in range(nu):
            for j in range(nv):
                flat[i + j * nu] = Ju[j, i]
        want = np.array([[flat[a + b * nv] for b in range(nu)]
                         for a in range(nv)])
        got = scramble_B(torch.tensor(np.stack([Ju, Ju])))
        np.testing.assert_array_equal(got[1].numpy(), want)
