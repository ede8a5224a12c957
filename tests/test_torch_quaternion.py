"""PyTorch port, quaternion states (nq != nv) against the JAX package
(float64, CPU).

Seeded quaternions, zero rotations and rotations near pi go through the
quaternion helpers, ``integrate_pos``, ``state_diff`` and ``_qpos_diff`` of
both packages at rtol 1e-12 (atol 1e-14 for entries near zero): the same
float64 operations in the same order, so only the last bits of sin, cos
and atan2 may differ.

The derivatives through a zero rotation (the AD linearizer's tangent
perturbation, ``torch.func.hessian`` in the cost quadratics) must be finite
in float64 and float32; the dtype-aware regulariser is what keeps the
1/theta^3 terms of the float32 Hessians finite.

The inline ball-joint pendulum of tests/test_linearize.py (nq 5, nv 4):
FD against AD within the port at that test's rtol 1e-4 / atol 1e-6, and the
port's FD and AD against the JAX package's at
tests/test_torch_linearize.py's rtol 1e-6 / atol 1e-8 (FD) and
tests/test_torch_linearize_ad.py's rtol 1e-8 / atol 1e-10 (AD)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from ilqg_mujoco_tpu import ilqr as jilqr
from ilqg_mujoco_tpu.ops import linearize as jlinearize
from ilqg_mujoco_tpu.physics import forward as jfwd
from ilqg_mujoco_tpu.physics import mjcf as jmjcf
from ilqg_mujoco_tpu.physics import spatial as jspatial
from ilqg_mujoco_tpu.physics.model import make_state as jmake_state
from ilqg_mujoco_torch import ilqr
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops import linearize
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics import mjcf, spatial
from ilqg_mujoco_torch.physics.model import make_state

RTOL, ATOL = 1e-12, 1e-14

_BALL_XML = """
<mujoco model="ball_pendulum">
  <option timestep="0.01" integrator="Euler"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="swivel" type="ball" damping="0.05"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.04" mass="1"/>
      <body pos="0 0 -0.4">
        <joint name="elbow" type="hinge" axis="0 1 0" damping="0.02"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="0.5"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="elbow" gear="1"/>
  </actuator>
</mujoco>
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _axis_angle(axis, angle):
    axis = _unit(axis)
    return np.concatenate([np.cos(angle / 2)[..., None],
                           np.sin(angle / 2)[..., None] * axis], -1)


def _quat_pairs(rng, n=6):
    """(qa, qb): seeded pairs, identical pairs (zero rotation between
    them), and pairs a rotation of pi -+ 1e-3 and pi -+ 1e-7 apart (both
    sides of the shortest-arc wrap)."""
    qb = _unit(rng.standard_normal((n + 6, 4)))
    qa = _unit(rng.standard_normal((n + 6, 4)))
    qa[n:n + 2] = qb[n:n + 2]
    angles = np.array([np.pi - 1e-3, np.pi + 1e-3, np.pi - 1e-7,
                       np.pi + 1e-7])
    rel = _axis_angle(rng.standard_normal((4, 3)), angles)
    qa[n + 2:] = np.asarray(jspatial.quat_mul(jnp.asarray(qb[n + 2:]),
                                              jnp.asarray(rel)))
    return qa, qb


def _omegas(rng, n=6):
    """Seeded angular velocities, zero ones, and ones whose rotation over
    dt = 1 is pi -+ 1e-6."""
    w = rng.standard_normal((n + 4, 3))
    w[n:n + 2] = 0.0
    w[n + 2:] = _unit(w[n + 2:]) * np.array([[np.pi - 1e-6],
                                              [np.pi + 1e-6]])
    return w


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    qa, qb = _quat_pairs(rng)
    w = _omegas(rng, len(qa) - 4)
    v = rng.standard_normal((len(qa), 3))
    t = lambda a: torch.tensor(a)
    j = jnp.asarray
    _close(spatial.quat_conj(t(qa)), jspatial.quat_conj(j(qa)), "conj")
    raw = 1.7 * qa
    _close(spatial.quat_normalize(t(raw)), jspatial.quat_normalize(j(raw)),
           "normalize")
    _close(spatial.quat_rotate_inv(t(qa), t(v)),
           jspatial.quat_rotate_inv(j(qa), j(v)), "rotate_inv")
    for dt in (1.0, 0.005):
        _close(spatial.quat_integrate(t(qa), t(w), dt),
               jspatial.quat_integrate(j(qa), j(w), dt), f"integrate {dt}")
    got = spatial.quat_sub(t(qa), t(qb))
    _close(got, jspatial.quat_sub(j(qa), j(qb)), "sub")
    # identical pairs give zero, and the pairs near pi stay on the
    # shortest arc (|v| <= pi)
    n = len(qa) - 6
    assert float(got[n:n + 2].abs().max()) < 1e-14
    norms = got[n + 2:].norm(dim=-1)
    assert bool((norms <= np.pi).all()) and bool((norms > 3.14).all())
    # the log map inverts the exponential away from the wrap
    q2 = spatial.quat_integrate(t(qb[:n]), got[:n], 1.0)
    _close(q2 * torch.sign(q2[:, :1]), t(qa[:n]) * torch.sign(t(qa[:n, :1])))


def _ball_model():
    return mjcf.load_model(xml_string=_BALL_XML), jmjcf.load_model(
        xml_string=_BALL_XML)


def _configs(m, rng, n=6):
    """Seeded configurations of ``m``: qpos0 plus noise with every
    quaternion re-drawn, and pairs (qa, qb) whose quaternions are zero
    (rows 0-1), pi -+ 1e-7 (rows 2-3) and a seeded rotation apart."""
    qa = m.qpos0 + 0.1 * rng.standard_normal((n, m.nq))
    qb = m.qpos0 + 0.1 * rng.standard_normal((n, m.nq))
    for jt, adr in zip(m.jnt_type, m.jnt_qposadr):
        if jt == 0:
            adr += 3
        elif jt != 1:
            continue
        qa[:, adr:adr + 4] = _unit(rng.standard_normal((n, 4)))
        qb[:, adr:adr + 4] = _unit(rng.standard_normal((n, 4)))
        qa[:2, adr:adr + 4] = qb[:2, adr:adr + 4]
        rel = _axis_angle(rng.standard_normal((2, 3)),
                          np.array([np.pi - 1e-7, np.pi + 1e-7]))
        qa[2:4, adr:adr + 4] = np.asarray(jspatial.quat_mul(
            jnp.asarray(qb[2:4, adr:adr + 4]), jnp.asarray(rel)))
    return qa, qb


@pytest.mark.parametrize("which", ["humanoid", "ball"])
def test_state_maps_match_jax(which):
    """integrate_pos (at the humanoid's dt and at h = 1), state_diff and
    _qpos_diff of both packages on seeded configurations of the humanoid
    (a free root and 21 hinges) and the ball-joint pendulum."""
    if which == "humanoid":
        m = envs.make("humanoid").model
        jm = jmjcf.load_model(str(envs.ASSETS / "humanoid.xml"))
    else:
        m, jm = _ball_model()
    rng = np.random.default_rng(1)
    qa, qb = _configs(m, rng)
    va = rng.standard_normal((len(qa), m.nv))
    vb = rng.standard_normal((len(qa), m.nv))
    va[0] = 0.0
    t = lambda a: torch.tensor(a)
    j = jnp.asarray
    for h in (m.opt.timestep, 1.0):
        _close(fwd.integrate_pos(m, t(qa), t(va), h),
               jax.vmap(lambda q, v: jfwd.integrate_pos(jm, q, v, h))(
                   j(qa), j(va)), f"integrate_pos h={h}")
    _close(linearize._qpos_diff(m, t(qa), t(qb)),
           jax.vmap(lambda a, b: jlinearize._qpos_diff(jm, a, b))(
               j(qa), j(qb)), "_qpos_diff")
    got = ilqr.state_diff(m, t(qa), t(va), t(qb), t(vb))
    _close(got, jax.vmap(lambda a, u, b, w: jilqr.state_diff(jm, a, u, b, w))(
        j(qa), j(va), j(qb), j(vb)), "state_diff")
    assert got.shape == (len(qa), 2 * m.nv)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_derivatives_finite_at_zero_rotation(dtype):
    """Forward-mode AD through integrate_pos at qvel = 0 (the AD
    linearizer's tangent directions) gives the exponential's derivative,
    0.5 q (x) (0, e_k) in the quaternion rows, and through quat_sub of two
    equal quaternions a finite tangent; torch.func.hessian of the
    humanoid's cost through integrate_pos at dx = 0 (the tassa cost
    quadratics) is finite."""
    env = envs.make("humanoid")
    m = env.model
    rng = np.random.default_rng(2)
    qpos = torch.tensor(_configs(m, rng)[0][1:4], dtype=dtype)
    nv = m.nv
    eye = torch.eye(nv, dtype=dtype).expand(3, nv, nv)
    with fwAD.dual_level():
        v = fwAD.make_dual(torch.zeros_like(eye), eye.contiguous())
        q = fwd.integrate_pos(m, qpos[:, None].expand(3, nv, m.nq), v, 1.0)
        tangent = fwAD.unpack_dual(q).tangent          # (3, nv, nq)
        quat = qpos[:, 3:7]
        d = fwAD.unpack_dual(spatial.quat_sub(q[..., 3:7], quat[:, None])
                             ).tangent
    assert bool(torch.isfinite(tangent).all())
    assert bool(torch.isfinite(d).all())
    # a unit quaternion moved by 0.5 q (x) (0, e_k) per unit of omega_k
    e = torch.cat([torch.zeros(3, 1, dtype=dtype), torch.eye(3, dtype=dtype)],
                  1)
    want = 0.5 * spatial.quat_mul(quat[:, None], e)
    tol = dict(rtol=1e-12, atol=1e-14) if dtype == torch.float64 else dict(
        rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tangent[:, 3:6, 3:7], want, **tol)
    torch.testing.assert_close(tangent[:, :3, :3],
                               torch.eye(3, dtype=dtype).expand(3, 3, 3),
                               **tol)
    s = make_state(m, 3, dtype=dtype, device="cpu").replace(qpos=qpos)
    quad = ilqr._cost_quadratics(env.cost_fn, m, s)
    for name, x in zip(("lx", "lu", "lxx", "luu", "lux"), quad):
        assert bool(torch.isfinite(x).all()), name
    assert quad[2].shape == (3, 2 * nv, 2 * nv)


@pytest.fixture(scope="module")
def ball_lin():
    """The ball-joint pendulum at a tilted quaternion, moving (the state of
    tests/test_linearize.py), linearized by both packages' fd and ad
    engines."""
    m, jm = _ball_model()
    assert (m.nq, m.nv) == (5, 4)

    def cost(qpos, qvel, ctrl):
        return ((qpos[..., :3] ** 2).sum(-1) + 0.1 * (qvel ** 2).sum(-1)
                + 0.01 * (ctrl ** 2).sum(-1))

    def jcost(qpos, qvel, ctrl):
        return (jnp.sum(qpos[:3] ** 2) + 0.1 * jnp.sum(qvel ** 2)
                + 0.01 * jnp.sum(ctrl ** 2))

    q = np.array([0.9689124, 0.199, 0.099, 0.0497])
    qpos = np.concatenate([q / np.linalg.norm(q), [0.0]])
    qvel, ctrl = np.array([0.3, -0.2, 0.1, 0.4]), np.array([0.2])
    s = make_state(m, 1, device="cpu").replace(
        qpos=torch.tensor(qpos)[None], qvel=torch.tensor(qvel)[None],
        ctrl=torch.tensor(ctrl)[None])
    js = jmake_state(jm).replace(qpos=jnp.asarray(qpos),
                                 qvel=jnp.asarray(qvel),
                                 ctrl=jnp.asarray(ctrl))
    port = {e: getattr(linearize, f"linearize_{e}")(m, s, cost)
            for e in ("fd", "ad")}
    ref = {e: jax.jit(lambda st, e=e: getattr(jlinearize, f"linearize_{e}")(
        jm, st, jcost))(js) for e in ("fd", "ad")}
    return port, ref


def test_ball_joint_fd_matches_ad(ball_lin):
    port, _ = ball_lin
    fd, ad = port["fd"], port["ad"]
    assert fd.A.shape == (1, 8, 8) and bool(torch.isfinite(fd.A).all())
    for f in ("A", "B"):
        torch.testing.assert_close(getattr(fd, f), getattr(ad, f),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("engine", ["fd", "ad"])
def test_ball_joint_linearization_matches_jax(ball_lin, engine):
    port, ref = ball_lin
    rtol, atol = (1e-6, 1e-8) if engine == "fd" else (1e-8, 1e-10)
    for f in port[engine]._fields:
        np.testing.assert_allclose(getattr(port[engine], f)[0].numpy(),
                                   np.asarray(getattr(ref[engine], f)),
                                   rtol=rtol, atol=atol, err_msg=f)
