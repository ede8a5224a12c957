"""PyTorch port, compat Riccati backward pass: the CUDA kernel's plain
version and its wrapper on the CPU against the JAX package's scan backward
pass and its Pallas kernel (interpret mode), and the port's general
backward pass against an independent numpy oracle.

Inputs are real: the linearization of three cart-pole instances' first
iLQR iteration, made by the port and handed to both packages as numpy.
Tolerances are those of tests/test_pallas_riccati.py (rtol 1e-9,
atol 1e-11): the recursions are the same math in float64, in another
order.  The test marked ``cuda`` compares the kernel with its plain version
on the card and skips elsewhere; on the card, where JAX may be missing,

    python -m pytest tests/test_torch_riccati.py -m cuda --noconftest

runs it alone (the JAX package is imported only inside the tests that
compare with it)."""

import dataclasses

import numpy as np
import pytest
import torch

from ilqg_mujoco_torch import ilqr
from ilqg_mujoco_torch.kernels import riccati
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops.linearize import linearize_traj
from ilqg_mujoco_torch.physics.model import make_state
from ilqg_mujoco_torch.utils.convert import to_numpy

TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(scope="module")
def problem():
    env = envs.pendulum()
    m, cfg = env.model, env.ilqr
    s0 = make_state(m, 3, device="cpu").replace(qpos=torch.tensor(
        [[0.05, 0.2], [-0.1, 0.4], [0.2, -0.3]], dtype=torch.float64))
    sol = ilqr.init_solver(m, s0, cfg)
    traj = ilqr.forward_pass(m, s0, sol, cfg)
    lin = linearize_traj(m, traj, env.cost_fn, cfg.lin)
    N = cfg.horizon
    args = (lin.A[:, :N], lin.B[:, :N], lin.gx, lin.gu[:, :N],
            ilqr.knot_gaps(m, traj))
    return env, traj, lin, args


def _jax_scan_gains(env, traj, lin):
    # JAX is imported where it is used: on a machine with a card and no JAX,
    # `pytest tests/test_torch_riccati.py -m cuda --noconftest` runs the
    # card test alone
    import jax
    import jax.numpy as jnp

    from ilqg_mujoco_tpu import ilqr as jilqr
    from ilqg_mujoco_tpu.models import envs as jenvs
    from ilqg_mujoco_tpu.ops.linearize import LinOut as JLinOut
    from ilqg_mujoco_tpu.physics.model import State as JState

    jenv = jenvs.pendulum()
    jtraj = JState(**{k: jnp.asarray(v) for k, v in to_numpy(traj).items()})
    jlin = JLinOut(*(jnp.asarray(x.numpy()) for x in lin))
    K, k = jax.jit(jax.vmap(lambda t, li: jilqr.backward_pass_compat(
        jenv.model, t, li, jenv.ilqr)))(jtraj, jlin)
    N = env.ilqr.horizon
    return np.asarray(K)[:, :N], np.asarray(k)[:, :N]


def test_plain_version_and_cpu_wrapper_match_jax_scan(problem):
    env, traj, lin, args = problem
    Kj, kj = _jax_scan_gains(env, traj, lin)
    before = riccati.LAUNCHES
    for fn in (riccati.backward_compat_batched_ref,
               riccati.backward_compat_batched):
        K, k = fn(*args, env.ilqr.mu)
        assert K.shape == (3, 20, 1, 4) and k.shape == (3, 20, 1)
        np.testing.assert_allclose(K.numpy(), Kj, **TOL)
        np.testing.assert_allclose(k.numpy(), kj, **TOL)
    assert riccati.LAUNCHES == before      # no kernel ran on the CPU


def test_cpu_wrapper_matches_pallas_kernel_ragged_batch(problem):
    """Bt=5 through the Pallas kernel in interpret mode (its ragged edge is
    padded to a 1024-lane tile) and through the port."""
    import jax.numpy as jnp

    from ilqg_mujoco_tpu.experimental.pallas_riccati import (
        backward_compat_batched as pallas_backward)

    env, _, _, args = problem
    idx = [0, 1, 2, 0, 1]
    a5 = [x[idx] for x in args]
    Kp, kp = pallas_backward(*(jnp.asarray(x.numpy()) for x in a5),
                             env.ilqr.mu, interpret=True)
    K, k = riccati.backward_compat_batched(*a5, env.ilqr.mu)
    np.testing.assert_allclose(K.numpy(), np.asarray(Kp), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(kp), **TOL)


def _numpy_backward_compat(A, B, gx, gu, diffs, mu, N):
    """Independent numpy transcription of inc/ilqr.h:133-176 for one
    instance (the oracle of tests/test_ilqr.py)."""
    v = gx[N].copy()
    V = np.outer(v, v)
    nu = B.shape[2]
    nv2 = A.shape[1]
    K = np.zeros((N + 1, nu, nv2))
    k = np.zeros((N + 1, nu))
    for t in range(N - 1, -1, -1):
        V = 0.5 * (V + V.T)
        At, Bt, q, r, c = A[t], B[t], gx[t], gu[t], diffs[t]
        Q = np.outer(q, q)
        R = np.outer(r, r)
        V = V + mu * np.eye(nv2)
        T = -2 * Bt.T @ V @ Bt - 2 * R
        K[t] = np.linalg.solve(T, 2 * Bt.T @ V @ At)
        k[t] = np.linalg.solve(T, Bt.T @ (v + 2 * V @ c) + r)
        ABK = At + Bt @ K[t]
        V = ABK.T @ V @ ABK + Q + K[t].T @ R @ K[t]
        v = 2 * (Bt @ k[t] + c) @ V @ ABK + v @ ABK + q + 2 * k[t] @ R @ K[t]
    return K, k


def test_general_backward_pass_vs_numpy_oracle(problem):
    """The port's general (any nu) backward pass, on the real nu=1
    instances and on a synthetic nu=2 batch."""
    env, traj, lin, _ = problem
    cfg = env.ilqr
    K, k = ilqr.backward_pass_compat(env.model, traj, lin, cfg)
    diffs = ilqr.knot_gaps(env.model, traj).numpy()
    for b in range(3):
        Kn, kn = _numpy_backward_compat(
            lin.A[b].numpy(), lin.B[b].numpy(), lin.gx[b].numpy(),
            lin.gu[b].numpy(), diffs[b], cfg.mu, cfg.horizon)
        np.testing.assert_allclose(K[b].numpy(), Kn, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(k[b].numpy(), kn, rtol=1e-8, atol=1e-10)

    rng = np.random.default_rng(0)
    N, n, nu, Bsz = 6, 4, 2, 2
    A = np.eye(n) + 0.05 * rng.standard_normal((Bsz, N + 1, n, n))
    B = 0.1 * rng.standard_normal((Bsz, N + 1, n, nu))
    gx = rng.standard_normal((Bsz, N + 1, n))
    gu = rng.standard_normal((Bsz, N + 1, nu))
    qpos = rng.standard_normal((Bsz, N + 1, 2))
    qvel = rng.standard_normal((Bsz, N + 1, 2))
    t = traj.map(lambda x: x[:Bsz, :N + 1]).replace(
        qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    lin2 = lin._replace(A=torch.tensor(A), B=torch.tensor(B),
                        gx=torch.tensor(gx), gu=torch.tensor(gu))
    cfg2 = type(cfg)(horizon=N, mu=cfg.mu)
    model2 = dataclasses.replace(env.model, nu=nu)
    K, k = ilqr.backward_pass_compat(model2, t, lin2, cfg2)
    d = np.concatenate([qpos[:, 1:] - qpos[:, :-1],
                        qvel[:, 1:] - qvel[:, :-1]], -1)
    for b in range(Bsz):
        Kn, kn = _numpy_backward_compat(A[b], B[b], gx[b], gu[b], d[b],
                                        cfg.mu, N)
        np.testing.assert_allclose(K[b].numpy(), Kn, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(k[b].numpy(), kn, rtol=1e-8, atol=1e-10)


def test_kernel_path_equals_general_path(problem):
    """iterate_compat's nu=1 route (kernel wrapper) and the general
    backward pass agree on real data."""
    env, traj, lin, _ = problem
    K1, k1 = ilqr.backward_compat(env.model, traj, lin, env.ilqr)
    K2, k2 = ilqr.backward_pass_compat(env.model, traj, lin, env.ilqr)
    assert K1.shape == K2.shape == (3, 21, 1, 4)
    np.testing.assert_allclose(K1.numpy(), K2.numpy(), **TOL)
    np.testing.assert_allclose(k1.numpy(), k2.numpy(), **TOL)
    assert not K1[:, -1].any() and not k1[:, -1].any()


def test_wrapper_rejects_bad_inputs(problem):
    _, _, _, (A, B, gx, gu, d) = problem
    with pytest.raises(ValueError, match="nu=1"):
        riccati.backward_compat_batched(A, torch.cat([B, B], -1), gx, gu, d,
                                        1.0)
    with pytest.raises(ValueError, match="gx"):
        riccati.backward_compat_batched(A, B, gx[:, :-1], gu, d, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        riccati.backward_compat_batched(A.float(), B, gx, gu, d, 1.0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(problem):
    """The CUDA kernel against its plain version on the card, in float64
    (rtol 1e-9, atol 1e-11) and float32, at ragged batch sizes.  float32:
    rtol 1e-4, atol 1e-6 * max|ref|, since 20 steps of the recursion with
    mu=1000 lose about three of float32's seven digits to cancellation."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env, _, _, args = problem
    for Bt in (5, 131, 4097):
        idx = torch.arange(Bt) % 3
        for dt in (torch.float64, torch.float32):
            a = [x[idx].to("cuda", dt) for x in args]
            before = riccati.LAUNCHES
            K, k = riccati.backward_compat_batched(*a, env.ilqr.mu)
            torch.cuda.synchronize()
            assert riccati.LAUNCHES == before + 1
            Kr, kr = riccati.backward_compat_batched_ref(*a, env.ilqr.mu)
            for got, ref in ((K, Kr), (k, kr)):
                tol = TOL if dt == torch.float64 else dict(
                    rtol=1e-4, atol=1e-6 * float(ref.abs().max()))
                np.testing.assert_allclose(got.cpu().numpy(),
                                           ref.cpu().numpy(), **tol)
