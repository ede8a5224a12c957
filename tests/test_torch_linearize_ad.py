"""PyTorch port, the AD linearizers and the constraint solver's
implicit-diff JVP against the JAX package (float64, CPU).

Inputs come from a seed and reach both packages as numpy arrays.  Limit
rows must be active for the JVP to mean anything, so the cart-pole's
joints are pushed past their ranges (slider +-1 m, hinge +-90 deg).

Tolerances:
* solver primal rtol 1e-10 / atol 1e-12, tangent rtol 1e-9 / atol 1e-12:
  the same CG and the same SPD solve in float64, in another summation
  order;
* ad/exact engines rtol 1e-8 / atol 1e-10: exact derivatives of two
  physics cores that agree to ~1e-15 (tests/test_torch_physics.py), so no
  FD noise amplifies the last-bit differences;
* FD against AD within the port rtol 1e-4, as the JAX package's
  test_fd_vs_ad_pendulum: eps=1e-6 central differences carry O(eps^2)
  truncation and ~1e-10 rounding, one-sided cost gradients O(eps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from ilqg_mujoco_tpu.models import envs as jenvs
from ilqg_mujoco_tpu.ops.linearize import LinearizeConfig as JLinCfg
from ilqg_mujoco_tpu.ops.linearize import linearize_traj as jlinearize_traj
from ilqg_mujoco_tpu.physics.model import State as JState
from ilqg_mujoco_tpu.physics.solver import _solve_qacc as jsolve_qacc
from ilqg_mujoco_torch import ilqr
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops import linalg
from ilqg_mujoco_torch.ops.linearize import (LinearizeConfig, _qpos_diff,
                                             linearize_traj)
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics import mjcf, solver
from ilqg_mujoco_torch.physics.model import make_state
from ilqg_mujoco_torch.utils.convert import to_numpy

ITER, LS_ITER = 30, 16


def _states(m, qpos, qvel, ctrl):
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    return make_state(m, len(qpos), device="cpu").replace(
        qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))


@pytest.fixture(scope="module")
def solve_inputs():
    """The constraint problems of three cart-pole states: inside the range,
    past both upper limits and past both lower limits, each moving further
    in.  Returns numpy (M, Mfac, qacc_smooth, J, D, aref, warmstart)."""
    m = envs.pendulum().model
    s = _states(m, [[0.3, 0.4], [1.04, 1.62], [-1.03, -1.6]],
                [[0.1, -0.2], [0.5, 1.0], [-0.4, -0.8]],
                [[0.2], [1.5], [-1.0]])
    s = s.replace(qacc_warmstart=torch.tensor(
        [[0.1, -0.1], [-2.0, 3.0], [1.0, 1.0]], dtype=torch.float64))
    _, aux = fwd.forward_full(m, s)
    B = s.qpos.shape[0]
    J = aux.efc.J.expand(B, *aux.efc.J.shape)
    return [x.numpy().copy() for x in (
        aux.kin.M, linalg.cholesky(aux.kin.M), aux.qacc_smooth, J,
        aux.efc.D, aux.efc.aref, s.qacc_warmstart)]


@pytest.mark.parametrize("tolerance", [0.0, 1e-8],
                         ids=["pinned", "early_exit"])
def test_solver_jvp_matches_jax(solve_inputs, tolerance):
    """The port's _SolveQacc forward-mode JVP against jax.jvp of the JAX
    package's custom-JVP _solve_qacc, with random tangents on every input
    (those of Mfac and warmstart must be discarded by both)."""
    M, Mfac, qs, J, D, aref, warm = solve_inputs
    rng = np.random.default_rng(0)
    tan = [rng.standard_normal(x.shape) for x in solve_inputs]
    tan[0] = tan[0] + np.swapaxes(tan[0], -1, -2)      # dM symmetric
    x_want, dx_want = [], []
    for b in range(M.shape[0]):
        f = lambda *a: jsolve_qacc(*a, ITER, tolerance, LS_ITER)
        (x, _), (dx, _) = jax.jvp(
            f, tuple(jnp.asarray(a[b]) for a in solve_inputs),
            tuple(jnp.asarray(t[b]) for t in tan))
        x_want.append(np.asarray(x))
        dx_want.append(np.asarray(dx))

    t = lambda a: torch.tensor(a)
    with fwAD.dual_level():
        duals = [fwAD.make_dual(t(a), t(d)) for a, d in zip(solve_inputs,
                                                             tan)]
        x, niter = solver._SolveQacc.apply(*duals, ITER, tolerance, LS_ITER)
        x, dx = fwAD.unpack_dual(x)
        assert fwAD.unpack_dual(niter).tangent is None
    # the limit rows are active at the solution of the two outer states
    jar = np.einsum("bij,bj->bi", J, x.numpy()) - aref
    active = (jar < 0) & (D > 0)
    assert active[1:].any(-1).all() and not active[0].any(), active
    np.testing.assert_allclose(x.numpy(), np.array(x_want), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(dx.numpy(), np.array(dx_want), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("tolerance", [0.0, 1e-8],
                         ids=["pinned", "early_exit"])
def test_solver_primal_is_the_cg_bit_for_bit(solve_inputs, tolerance):
    """Without dual tensors the Function returns exactly what _solve_cg
    returns, in both solver modes."""
    args = [torch.tensor(a) for a in solve_inputs]
    x, niter = solver._SolveQacc.apply(*args, ITER, tolerance, LS_ITER)
    x_cg, niter_cg = solver._solve_cg(*args, ITER, tolerance, LS_ITER)
    assert torch.equal(x, x_cg) and torch.equal(niter, niter_cg)


@pytest.fixture(scope="module")
def traj():
    """Three instances rolled out 20 steps under constant ctrl; the last two
    start against both joint limits, so limit rows are active on some
    knots."""
    env = envs.pendulum()
    s = _states(env.model, [[0.05, 0.2], [0.95, 1.5], [-0.97, -1.52]],
                [[0.1, -0.3], [0.5, 1.0], [-0.3, -0.6]],
                [[0.5], [2.5], [-2.0]])
    return env, ilqr.init_solver(env.model, s, env.ilqr).traj


def _jax_states(t):
    return JState(**{k: jnp.asarray(v) for k, v in to_numpy(t).items()})


@pytest.mark.parametrize("engine", ["ad", "exact"])
def test_ad_engines_match_jax(traj, engine):
    env, t = traj
    got = linearize_traj(env.model, t, env.cost_fn,
                         LinearizeConfig(engine=engine))
    jenv = jenvs.pendulum()
    want = jax.jit(jax.vmap(lambda s: jlinearize_traj(
        jenv.model, s, jenv.cost_fn, JLinCfg(engine=engine))))(
            _jax_states(t))
    assert got.A.shape == (3, 21, 4, 4) and got.B.shape == (3, 21, 4, 1)
    for name in ("A", "B", "gx", "gu", "cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


def test_ad_compat_transpose_flag_matches_jax(traj):
    """The ad engine's Euler assembly honours compat_transpose_A as the
    JAX package's does."""
    env, t = traj
    cfg = dict(engine="ad", compat_transpose_A=True)
    got = linearize_traj(env.model, t, env.cost_fn, LinearizeConfig(**cfg))
    jenv = jenvs.pendulum()
    want = jax.jit(jax.vmap(lambda s: jlinearize_traj(
        jenv.model, s, jenv.cost_fn, JLinCfg(**cfg))))(_jax_states(t))
    np.testing.assert_allclose(got.A.numpy(), np.asarray(want.A), rtol=1e-8,
                               atol=1e-10)


def test_fd_vs_ad_pendulum():
    """Central FD with eps=1e-6 and exact forward-mode AD agree within the
    port (the JAX package's test_fd_vs_ad_pendulum)."""
    env = envs.pendulum()
    s = _states(env.model, [[0.1, 0.3]], [[0.2, -0.5]], [[0.4]])
    fd = linearize_traj(env.model, s, env.cost_fn, LinearizeConfig())
    ad = linearize_traj(env.model, s, env.cost_fn,
                        LinearizeConfig(engine="ad"))
    for name in ("A", "B"):
        np.testing.assert_allclose(getattr(fd, name).numpy(),
                                   getattr(ad, name).numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # FD cost grads are one-sided (reference protocol) => O(eps) error
    for name in ("gx", "gu"):
        np.testing.assert_allclose(getattr(fd, name).numpy(),
                                   getattr(ad, name).numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_exact_engine_rejects_compat_flags():
    """engine='exact' has no Euler assembly, so the compat layout flags
    would be a silent no-op: the config refuses them."""
    with pytest.raises(ValueError, match="exact"):
        LinearizeConfig(engine="exact", compat_transpose_A=True)
    with pytest.raises(ValueError, match="exact"):
        LinearizeConfig(engine="exact", compat_scramble_B=True)
    with pytest.raises(ValueError, match="engine"):
        LinearizeConfig(engine="bogus")
    for engine in ("fd", "ad", "exact"):
        LinearizeConfig(engine=engine)
    LinearizeConfig(engine="ad", compat_transpose_A=True,
                    compat_scramble_B=True)


def test_qpos_diff(assets_dir):
    """Slide/hinge configurations subtract; quaternion joints raise until
    their slice."""
    m = envs.pendulum().model
    a = torch.tensor([[0.3, -0.2]], dtype=torch.float64)
    b = torch.tensor([[0.1, 0.4]], dtype=torch.float64)
    assert torch.equal(_qpos_diff(m, a, b), a - b)
    humanoid = mjcf.load_model(str(assets_dir / "humanoid.xml"))
    q = torch.zeros((1, humanoid.nq), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="slice"):
        _qpos_diff(humanoid, q, q)
