"""PyTorch port, the full humanoid (a free root and 21 hinges: nq 28,
nv 27, nu 21; 161 contact pairs) against the MuJoCo C core (float64, CPU).

The JAX package's humanoid programs take ~12 minutes to compile on
XLA:CPU (tests/test_humanoid.py), so this file holds the port to the C
core directly, at the JAX package's own tolerances for the same checks:

* the loader: sizes, inertias, joints, geoms, actuators and the
  compile-time constraint weights against ``mujoco.MjModel``
  (tests/test_mjcf_parity.py::test_humanoid_compile, atol 1e-10; the
  weights rtol 1e-9 / atol 1e-12, inertia tensors atol 1e-9);
* qacc at the reference pose and at a seeded pose with velocities
  (tests/test_physics_parity.py::test_humanoid_qacc: rtol 1e-6, atol 1e-7
  and 1e-5);
* 200 default-mode steps of the fall onto the floor
  (::test_humanoid_fall_trajectory: atol 2e-3 at step 100, 2e-2 at step
  200; the solvers differ, projected CG against Newton);
* a cut tassa+ad solve (horizon 8, 3 iterations, alphas (1, 0.3, 0.05),
  as tests/test_humanoid.py) that is finite and strictly descends."""

import dataclasses

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from ilqg_mujoco_torch import ilqr, mpc  # noqa: E402
from ilqg_mujoco_torch.models import envs  # noqa: E402
from ilqg_mujoco_torch.physics import collision, constraint  # noqa: E402
from ilqg_mujoco_torch.physics import forward as fwd  # noqa: E402
from ilqg_mujoco_torch.physics.model import make_state  # noqa: E402

ASSET = envs.ASSETS / "humanoid.xml"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    mm = mujoco.MjModel.from_xml_path(str(ASSET))
    return envs.make("humanoid").model, mm


def _mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def test_loader_matches_mujoco(models):
    m, mm = models
    tol = 1e-10
    assert (m.nq, m.nv, m.nu) == (28, 27, 21)
    assert (m.nbody, m.njnt, m.ngeom) == (mm.nbody, mm.njnt, mm.ngeom)
    for f in ("body_mass", "body_pos", "body_ipos", "jnt_range", "jnt_axis",
              "jnt_pos", "qpos0", "dof_armature", "dof_damping",
              "jnt_stiffness", "geom_size", "geom_pos", "geom_friction",
              "geom_solref", "geom_solimp", "geom_margin",
              "actuator_ctrlrange"):
        np.testing.assert_allclose(getattr(m, f), getattr(mm, f), atol=tol,
                                   err_msg=f)
    np.testing.assert_array_equal(m.jnt_type, mm.jnt_type)
    np.testing.assert_allclose(m.actuator_gear, mm.actuator_gear[:, 0],
                               atol=tol)
    # inertia tensors (the principal-frame decomposition is ambiguous)
    for b in range(m.nbody):
        R1, R2 = _mat(m.body_iquat[b]), _mat(mm.body_iquat[b])
        np.testing.assert_allclose(R1 @ np.diag(m.body_inertia[b]) @ R1.T,
                                   R2 @ np.diag(mm.body_inertia[b]) @ R2.T,
                                   atol=1e-9)
    for f in ("dof_invweight0", "body_invweight0"):
        np.testing.assert_allclose(getattr(m, f), getattr(mm, f), rtol=1e-9,
                                   atol=1e-12, err_msg=f)


def test_contact_slots_and_rows(models):
    """161 static pairs (100 capsule-capsule, 39 sphere-capsule, 16
    plane-capsule, 3 plane-sphere, 3 sphere-sphere) give 277 slots: 242
    condim-1 and 35 condim-3; with the 21 limited hinges' lower and upper
    rows, 42 + 242 + 4 x 35 = 424 constraint rows per state."""
    m, _ = models
    assert len(m.pair_geom1) == 161
    meta = collision.slot_meta(m)
    assert (len(meta.condim), int((meta.condim == 1).sum()),
            int((meta.condim == 3).sum())) == (277, 242, 35)
    s = make_state(m, 2, device="cpu")
    _, aux = fwd.forward_full(m, s)
    assert aux.contacts.dist.shape == (2, 277)
    assert aux.efc.J.shape == (2, 424, 27)
    rt = constraint._row_tensors(m, "cpu", torch.float64)
    assert len(rt.qadr) == 42


def _qacc(m, mm, qpos, qvel):
    md = mujoco.MjData(mm)
    md.qpos[:], md.qvel[:] = qpos, qvel
    mujoco.mj_forward(mm, md)
    s = make_state(m, 1, device="cpu").replace(
        qpos=torch.tensor(qpos)[None], qvel=torch.tensor(qvel)[None])
    return fwd.forward(m, s).qacc[0].numpy(), md.qacc.copy()


def test_qacc_matches_mujoco(models):
    m, mm = models
    got, want = _qacc(m, mm, mm.qpos0.copy(), np.zeros(m.nv))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    rng = np.random.RandomState(2)
    qpos = mm.qpos0.copy()
    qpos[7:] += rng.uniform(-0.1, 0.1, m.nq - 7)
    qvel = rng.uniform(-0.5, 0.5, m.nv)
    got, want = _qacc(m, mm, qpos, qvel)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_fall_matches_mujoco(models):
    """The humanoid falls from qpos0 onto the floor: 200 steps at
    dt=0.005 through multi-contact landing."""
    m, mm = models
    md = mujoco.MjData(mm)
    s = make_state(m, 1, device="cpu")
    for i in range(200):
        mujoco.mj_step(mm, md)
        s = fwd.step(m, s)
        if i == 100:
            np.testing.assert_allclose(s.qpos[0].numpy(), md.qpos,
                                       atol=2e-3)
    np.testing.assert_allclose(s.qpos[0].numpy(), md.qpos, atol=2e-2)


def test_cut_solve_descends():
    """3 tassa+ad iterations of the standing humanoid over 4 knots, with
    the env's value scaling and reg_init: a finite trace that falls at
    every accepted step and ends strictly lower."""
    env = envs.make("humanoid")
    env = dataclasses.replace(
        env, ilqr=dataclasses.replace(env.ilqr, horizon=4, iterations=3,
                                      alphas=(1.0, 0.3, 0.05)))
    s0, sol0 = mpc.init(env, device="cpu")
    sol, trace = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    trace = trace[0]
    assert bool(torch.isfinite(trace).all()), trace
    assert bool((trace.diff() <= 1e-9).all()), trace
    assert float(trace[-1]) < float(trace[0]), trace
    assert bool(torch.isfinite(sol.K).all()) and bool(
        torch.isfinite(sol.traj.qpos).all())
