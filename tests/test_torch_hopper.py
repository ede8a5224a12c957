"""PyTorch port, the hopper (contacts, the Euler integrator, nu = 3)
against the JAX package and the MuJoCo C core (float64, CPU).

States come from ``mujoco.mj_step`` warm-ins and seeded perturbations and
reach both packages as numpy arrays.  One JAX jit of ``fwd.step`` (pinned
mode) serves the file.  Tolerances:

* one forward, qacc at rtol 1e-9 / atol 1e-10, and 300 pinned Euler steps
  at atol 1e-8: the same float64 arithmetic in another summation order,
  through contact;
* 300 default-mode steps against the C core at tests/test_physics_parity.py's
  bounds (5e-4 at step 150, 5e-3 at step 300): the solvers differ
  (projected CG against Newton) but solve the same convex problem;
* the compat+fd solves against tools/golden_ref.py at
  tests/test_golden_hopper.py's tolerances (trace rtol 1e-4; ctrl rtol
  1e-3, atol 1e-5; qpos rtol 1e-4, atol 1e-6).

The tassa+ad path against the JAX package is in
tests/test_torch_hopper_tassa.py."""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from tools import golden_ref  # noqa: E402

from ilqg_mujoco_tpu.physics import forward as jfwd  # noqa: E402
from ilqg_mujoco_tpu.physics import mjcf as jmjcf  # noqa: E402
from ilqg_mujoco_tpu.physics.model import State as JState  # noqa: E402
from ilqg_mujoco_torch import ilqr  # noqa: E402
from ilqg_mujoco_torch.ilqr import ILQRConfig  # noqa: E402
from ilqg_mujoco_torch.models import envs  # noqa: E402
from ilqg_mujoco_torch.ops.linearize import (LinearizeConfig,  # noqa: E402
                                             linearize_fd)
from ilqg_mujoco_torch.parallel import batch  # noqa: E402
from ilqg_mujoco_torch.physics import forward as fwd  # noqa: E402
from ilqg_mujoco_torch.physics import mjcf  # noqa: E402
from ilqg_mujoco_torch.utils.convert import (state_from_numpy,  # noqa: E402
                                             to_numpy)

JAX_ASSET = ROOT / "ilqg_mujoco_tpu" / "models" / "assets" / "hopper.xml"
ASSET = ROOT / "ilqg_mujoco_torch" / "models" / "assets" / "hopper.xml"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_cost(qpos, qvel, ctrl):
    """tests/test_golden_hopper.py's cost."""
    return (1.0 * (qpos[1] - 1.25) ** 2 + 0.1 * qpos[2] ** 2
            + 0.01 * np.sum(qvel ** 2))


def _cost(qpos, qvel, ctrl):
    return (1.0 * (qpos[..., 1] - 1.25) ** 2 + 0.1 * qpos[..., 2] ** 2
            + 0.01 * (qvel ** 2).sum(-1))


@pytest.fixture(scope="module")
def models():
    return jmjcf.load_model(str(JAX_ASSET)), envs.make("hopper").model


@pytest.fixture(scope="module")
def jstep(models):
    """The file's one JAX compile: a pinned step (30 iterations,
    tolerance 0)."""
    jm = models[0]
    return jax.jit(lambda s: jfwd.step(jm, s, iterations=30, tolerance=0.0))


def _c_core(warm):
    """A MuJoCo C-core hopper after ``warm`` steps: (mm, md)."""
    mm = mujoco.MjModel.from_xml_path(str(JAX_ASSET))
    md = mujoco.MjData(mm)
    for _ in range(warm):
        mujoco.mj_step(mm, md)
    return mm, md


def _state_of(md, n=1):
    """The cpMjData subset of ``md`` as a port State of n instances."""
    snap = golden_ref._Snap.of(md)
    d = {f: np.broadcast_to(np.asarray(getattr(snap, f)),
                            (n,) + np.shape(getattr(snap, f)))
         for f in golden_ref._Snap.__slots__}
    return state_from_numpy(d, device="cpu")


def _jstate(s, i):
    return JState(**{k: jnp.asarray(v[i]) for k, v in to_numpy(s).items()})


def test_asset_and_model_arrays_match(models):
    jm, m = models
    assert ASSET.read_bytes() == JAX_ASSET.read_bytes()
    assert mjcf.load_model(str(ASSET)).nv == m.nv == 6
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(m, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "opt":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(jm.dof_mask, m.dof_mask)


@pytest.fixture(scope="module")
def contact_states():
    """C-core states at warm-in depths 100, 200 and 320, each twice more
    with seeded qpos/qvel/ctrl perturbations: a port State of 9."""
    mm, md = _c_core(0)
    rng = np.random.default_rng(3)
    rows, steps = [], 0
    for depth in (100, 200, 320):
        for _ in range(depth - steps):
            mujoco.mj_step(mm, md)
        steps = depth
        for i in range(3):
            s = to_numpy(_state_of(md))
            if i:
                s["qpos"] = s["qpos"] + 0.01 * rng.standard_normal((1, 6))
                s["qvel"] = s["qvel"] + 0.1 * rng.standard_normal((1, 6))
                s["ctrl"] = rng.uniform(-1, 1, (1, 3))
            rows.append(s)
    return state_from_numpy({k: np.concatenate([r[k] for r in rows])
                             for k in rows[0]}, device="cpu")


def test_qacc_matches_jax_in_contact(models, jstep, contact_states):
    _, m = models
    s = contact_states
    _, aux = fwd.forward_full(m, s, iterations=30, tolerance=0.0)
    # the unperturbed states, and most of the others, are in contact
    touching = (aux.efc.D[:, 6:] > 0).any(-1)
    assert bool(touching[::3].all()) and int(touching.sum()) >= 6
    got = fwd.step(m, s, iterations=30, tolerance=0.0)
    for i in range(s.qpos.shape[0]):
        want = jstep(_jstate(s, i))
        np.testing.assert_allclose(got.qacc[i].numpy(), np.asarray(want.qacc),
                                   rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(got.qvel[i].numpy(), np.asarray(want.qvel),
                                   rtol=1e-9, atol=1e-10)


def _ctrl(i):
    return 0.3 * np.sin(0.05 * i + np.arange(3))


def test_pinned_euler_trajectory_matches_jax(models, jstep):
    """150 pinned Euler steps from qpos0: the hopper falls, lands (step
    38), bounces (115) and lands again (134) under a sinusoidal ctrl."""
    jm, m = models
    s = _state_of(_c_core(0)[1])
    js = _jstate(s, 0)
    for i in range(150):
        u = _ctrl(i)
        s = fwd.step(m, s.replace(ctrl=torch.tensor(u)[None]), iterations=30,
                     tolerance=0.0)
        js = jstep(js.replace(ctrl=jnp.asarray(u)))
        np.testing.assert_allclose(s.qpos[0].numpy(), np.asarray(js.qpos),
                                   atol=1e-8)
        np.testing.assert_allclose(s.qvel[0].numpy(), np.asarray(js.qvel),
                                   atol=1e-8)


def test_euler_trajectory_matches_c_core(models):
    """tests/test_physics_parity.py::test_hopper_trajectory for the port:
    300 default-mode steps (early-exit CG) against mj_step."""
    _, m = models
    mm, md = _c_core(0)
    s = _state_of(md)
    for i in range(300):
        u = _ctrl(i)
        md.ctrl[:] = u
        mujoco.mj_step(mm, md)
        s = fwd.step(m, s.replace(ctrl=torch.tensor(u)[None]))
        if i == 150:
            np.testing.assert_allclose(s.qpos[0].numpy(), md.qpos, atol=5e-4)
    np.testing.assert_allclose(s.qpos[0].numpy(), md.qpos, atol=5e-3)


def test_prediction_accuracy_hopper(models):
    """tests/test_linearize.py::test_prediction_accuracy_hopper for the
    port: after 500 steps (the C core's warm-in here) and a ctrl bias, the
    fd linearization predicts the perturbed next state to first order."""
    _, m = models
    env = envs.make("hopper")
    s = _state_of(_c_core(500)[1])
    s = s.replace(ctrl=s.ctrl - 0.1)
    lin = linearize_fd(m, s, env.cost_fn)
    h = 1e-6
    nxt = fwd.step(m, s)
    nxt_p = fwd.step(m, s.replace(qpos=s.qpos + h, qvel=s.qvel + h,
                                  ctrl=s.ctrl + h))
    pred = (torch.cat([nxt.qpos, nxt.qvel], -1)
            + (lin.A @ torch.full((12, 1), h, dtype=torch.float64))[..., 0]
            + (lin.B @ torch.full((3, 1), h, dtype=torch.float64))[..., 0])
    resid = (pred - torch.cat([nxt_p.qpos, nxt_p.qvel], -1)).abs()
    assert float(resid.max()) < 1e-8, resid


def _golden(warm, n, iters, scramble=False):
    """The reference algorithm on the C core from ``warm``: (trace, ctrl,
    qpos, the warmed-in md)."""
    mm, md = _c_core(warm)
    ref = golden_ref.RefILQR(mm, md, _np_cost, n, scramble_B=scramble)
    trace = ref.solve(golden_ref._Snap.of(md), iters)
    return (trace, np.array([s.ctrl for s in ref.traj]),
            np.array([s.qpos for s in ref.traj]), md)


def _compat_cfg(n, iters, scramble=False):
    return ILQRConfig(horizon=n, iterations=iters, mode="compat",
                      lin=LinearizeConfig(engine="fd", compat_transpose_A=True,
                                          compat_scramble_B=scramble))


@pytest.mark.parametrize("warm", [100, 320])
def test_golden_solve_matches_reference(models, warm):
    """tests/test_golden_hopper.py::test_hopper_solve_matches_reference for
    the port, from the C core's warm-in state: N=40, 10 iterations, nu = 3
    through backward_pass_compat."""
    _, m = models
    trace_ref, ctrl_ref, qpos_ref, md = _golden(warm, 40, 10)
    s = _state_of(md)
    cfg = _compat_cfg(40, 10)
    sol, trace = ilqr.solve(m, _cost, s, ilqr.init_solver(m, s, cfg), cfg)
    np.testing.assert_allclose(trace[0].numpy(), trace_ref, rtol=1e-4)
    np.testing.assert_allclose(sol.traj.ctrl[0].numpy(), ctrl_ref,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(sol.traj.qpos[0].numpy(), qpos_ref,
                               rtol=1e-4, atol=1e-6)


def test_scrambled_B_solve_matches_reference(models):
    """tests/test_golden_hopper.py::test_hopper_solve_bitfaithful_scrambled_B
    for the port: warm-in 100, N=8, 2 iterations with the reference
    binary's ctrl-Jacobian layout bug on both sides."""
    _, m = models
    trace_ref, ctrl_ref, _, md = _golden(100, 8, 2, scramble=True)
    s = _state_of(md)
    cfg = _compat_cfg(8, 2, scramble=True)
    sol, trace = ilqr.solve(m, _cost, s, ilqr.init_solver(m, s, cfg), cfg)
    np.testing.assert_allclose(trace[0].numpy(), trace_ref, rtol=1e-4)
    np.testing.assert_allclose(sol.traj.ctrl[0].numpy(), ctrl_ref,
                               rtol=1e-3, atol=1e-5)


def test_batched_solve_equals_single_solves(models):
    """A diverse B=3 batch through make_batched_solve, instance by instance
    against B=1 solves (compat+fd, N=8, 2 iterations): the early-exit CG
    gives every instance the iterates it would get alone."""
    _, m = models
    env = dataclasses.replace(envs.make("hopper", mode="compat", engine="fd"),
                              ilqr=_compat_cfg(8, 2))
    md = _c_core(100)[1]
    s = _state_of(md, 3)
    rng = np.random.default_rng(5)
    s = s.replace(qpos=s.qpos + 0.01 * torch.tensor(rng.standard_normal((3,
                                                                         6))))
    solve = batch.make_batched_solve(env)
    sol, trace = solve(s, ilqr.init_solver(m, s, env.ilqr))
    for i in range(3):
        one = s.map(lambda x: x[i:i + 1])
        sol1, trace1 = solve(one, ilqr.init_solver(m, one, env.ilqr))
        for got, want in ((trace[i], trace1[0]), (sol.K[i], sol1.K[0]),
                          (sol.traj.qpos[i], sol1.traj.qpos[0])):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-12, atol=1e-14)


@pytest.mark.slow
@pytest.mark.parametrize("warm", [100, 320])
def test_closed_loop_mpc_matches_reference(models, warm):
    """test_golden_hopper.py::test_hopper_closed_loop_mpc_matches_reference
    for the port: 20 MPC frames through contact (N=12, 4 iterations per
    frame) against the C-core oracle loop, rtol 1e-3 (qpos atol 1e-6,
    ctrl atol 1e-5).  Tens of eager solves: a minute or more here."""
    from ilqg_mujoco_torch import mpc
    from ilqg_mujoco_torch.models.envs import Env

    _, m = models
    mm, md = _c_core(warm)
    s = _state_of(md)
    qpos_ref, ctrl_ref = golden_ref.run_mpc_golden(mm, md, _np_cost, 12, 4,
                                                   20)
    env = Env(name="hopper_golden", model=m, cost_fn=_cost,
              ilqr=_compat_cfg(12, 4), warm_steps=0)
    out = mpc.run(env, 20, s)
    np.testing.assert_allclose(out.env_states.qpos[0].numpy(), qpos_ref,
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(out.controls[0].numpy(), ctrl_ref,
                               rtol=1e-3, atol=1e-5)
