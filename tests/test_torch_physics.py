"""PyTorch port, physics layer: the same seeded cart-pole states through the
JAX package and the port (float64, CPU).

Tolerances: forward dynamics are the same arithmetic in both packages, so
only the order of floating-point operations differs (rtol 1e-10, atol 1e-12
on qacc); 100 RK4 steps through the joint limits hold atol 1e-10 per step,
the bound tests/test_physics_parity.py holds the JAX package to against the
MuJoCo C core."""

import dataclasses
import gc
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqg_mujoco_tpu.physics import forward as jfwd
from ilqg_mujoco_tpu.physics import mjcf as jmjcf
from ilqg_mujoco_tpu.physics.model import make_state as jmake_state
from ilqg_mujoco_torch.ops import linalg
from ilqg_mujoco_torch.physics import forward as tfwd
from ilqg_mujoco_torch.physics import mjcf as tmjcf
from ilqg_mujoco_torch.physics.model import make_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_ASSETS = ROOT / "ilqg_mujoco_tpu" / "models" / "assets"
ASSET = ROOT / "ilqg_mujoco_torch" / "models" / "assets" / "cartpole.xml"


@pytest.fixture(scope="module")
def models():
    return jmjcf.load_model(str(JAX_ASSETS / "cartpole.xml")), \
        tmjcf.load_model(str(ASSET))


def _seeded_states(n=5, seed=0):
    """Cart-pole states, some beyond the joint limits (slider +-1 m, hinge
    +-90 deg), so limit rows are active."""
    rng = np.random.RandomState(seed)
    qpos = rng.uniform(-1.2, 1.2, (n, 2)) * [1.0, 1.5]
    qvel = rng.uniform(-2, 2, (n, 2))
    ctrl = rng.uniform(-3, 3, (n, 1))
    return qpos, qvel, ctrl


def _port_state(model, qpos, qvel, ctrl):
    return make_state(model, len(qpos), device="cpu").replace(
        qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
        ctrl=torch.tensor(ctrl))


def test_asset_and_model_arrays_match(models):
    jm, tm = models
    assert ASSET.read_bytes() == (JAX_ASSETS / "cartpole.xml").read_bytes()
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "opt":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(jm.dof_mask, tm.dof_mask)
    np.testing.assert_array_equal(jm.ancestor_mask, tm.ancestor_mask)


def test_qacc_matches_jax(models):
    jm, tm = models
    qpos, qvel, ctrl = _seeded_states()
    got = tfwd.forward(tm, _port_state(tm, qpos, qvel, ctrl)).qacc.numpy()
    js = jmake_state(jm)
    f = jax.jit(jax.vmap(lambda q, v, u: jfwd.forward(
        jm, js.replace(qpos=q, qvel=v, ctrl=u)).qacc))
    want = np.asarray(f(jnp.asarray(qpos), jnp.asarray(qvel),
                        jnp.asarray(ctrl)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_batched_call_equals_single_calls(models):
    _, tm = models
    qpos, qvel, ctrl = _seeded_states()
    batched = tfwd.forward(tm, _port_state(tm, qpos, qvel, ctrl)).qacc
    for i in range(len(qpos)):
        one = tfwd.forward(tm, _port_state(tm, qpos[i:i + 1], qvel[i:i + 1],
                                           ctrl[i:i + 1])).qacc
        np.testing.assert_allclose(batched[i:i + 1].numpy(), one.numpy(),
                                   rtol=1e-13, atol=1e-13)


def test_rk4_trajectory_matches_jax(models):
    """100 RK4 steps under u = 0.5 sin(0.3 i): the slider runs into its
    limit, so the constraint solver's early-exit loop is exercised."""
    jm, tm = models
    step = jax.jit(lambda st: jfwd.step(jm, st))
    js, ts = jmake_state(jm), make_state(tm, 1, device="cpu")
    for i in range(100):
        u = 0.5 * np.sin(0.3 * i)
        js = step(js.replace(ctrl=jnp.asarray([u])))
        ts = tfwd.step(tm, ts.replace(ctrl=torch.tensor([[u]])))
        np.testing.assert_allclose(ts.qpos[0].numpy(), np.asarray(js.qpos),
                                   atol=1e-10)
        np.testing.assert_allclose(ts.qvel[0].numpy(), np.asarray(js.qvel),
                                   atol=1e-10)
    assert abs(float(ts.qpos[0, 0])) > 0.4      # the run went somewhere


def test_solver_niter(models):
    """Pinned mode (the FD protocol) runs exactly `iterations` times for
    every instance; early exit stops each instance within the cap."""
    _, tm = models
    s = _port_state(tm, *_seeded_states())
    _, aux = tfwd.forward_full(tm, s, iterations=30, tolerance=0.0)
    assert aux.solver_niter.tolist() == [30] * 5
    _, aux = tfwd.forward_full(tm, s)
    n = aux.solver_niter
    assert bool(((n >= 1) & (n <= tm.opt.iterations)).all())


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n)
    return A @ A.T + n * np.eye(n)


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_cholesky_matches_numpy(n):
    A = np.stack([_spd(n, n + s) for s in range(3)])
    L = linalg.cholesky(torch.tensor(A)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-12,
                               atol=1e-12)


def test_cho_solve_vector_and_matrix():
    A = _spd(6, 0)
    L = linalg.cholesky(torch.tensor(A))
    b = np.random.RandomState(1).randn(6)
    B = np.random.RandomState(2).randn(6, 4)
    np.testing.assert_allclose(linalg.cho_solve(L, torch.tensor(b)).numpy(),
                               np.linalg.solve(A, b), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(linalg.cho_solve(L, torch.tensor(B)).numpy(),
                               np.linalg.solve(A, B), rtol=1e-10, atol=1e-12)


def test_non_pd_gives_nan():
    L = linalg.cholesky(-torch.eye(3, dtype=torch.float64))
    assert not bool(torch.isfinite(L).all())


def test_dropped_model_serves_nothing_to_the_next():
    """The JAX package caches a mask by ``id(model)``
    (ilqg_mujoco_tpu/physics/smooth.py:77-84), so a freed model's id,
    reused by the next model, can serve that model stale constants.  The
    port's ``on_device`` cache keys on the model itself: a cart-pole
    stepped and dropped leaves the hopper loaded after it with its own
    constants, and its qacc in contact matches the MuJoCo C core at the
    hopper physics test's qacc tolerance (rtol 1e-9, atol 1e-10)."""
    mujoco = pytest.importorskip("mujoco")
    cartpole = tmjcf.load_model(str(ASSET))
    tfwd.step(cartpole, make_state(cartpole, 1, device="cpu"))
    del cartpole
    gc.collect()

    hopper = tmjcf.load_model(
        str(ROOT / "ilqg_mujoco_torch" / "models" / "assets" / "hopper.xml"))
    mm = mujoco.MjModel.from_xml_path(str(JAX_ASSETS / "hopper.xml"))
    md = mujoco.MjData(mm)
    for _ in range(100):             # settled onto the floor: 2 contacts
        mujoco.mj_step(mm, md)
    mujoco.mj_forward(mm, md)
    assert md.ncon > 0
    s = make_state(hopper, 1, device="cpu").replace(
        qpos=torch.tensor(md.qpos[None]), qvel=torch.tensor(md.qvel[None]),
        ctrl=torch.tensor(md.ctrl[None]))
    got = tfwd.forward(hopper, s)
    np.testing.assert_allclose(got.qacc[0].numpy(), md.qacc, rtol=1e-9,
                               atol=1e-10)
