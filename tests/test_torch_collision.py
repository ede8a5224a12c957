"""PyTorch port, collision and the contact constraint rows against the JAX
package and the MuJoCo C core (float64, CPU).

Collision takes geom frames, not joints: the inputs are numpy poses
(seeded random ones, the capsule-capsule geometry cases of
tests/test_collision_capsule.py, an upright capsule over the plane) fed
as ``geom_xpos``/``geom_xmat`` to both packages' ``collide``.  The two are
the same float64 arithmetic in another summation order: rtol 1e-12
(atol 1e-12 for entries near zero).

The constraint rows are compared on the hopper at C-core states (warm-in
depths 0, 100 and 320 of ``mujoco.mj_step``) and at seeded perturbations
of them, row for row against the JAX package (rtol 1e-10, atol 1e-12 of
each field's largest entry), and the included rows against ``mujoco``'s
``efc_J`` and ``efc_pos``."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

mujoco = pytest.importorskip("mujoco")

from ilqg_mujoco_tpu.physics import collision as jcollision  # noqa: E402
from ilqg_mujoco_tpu.physics import forward as jfwd  # noqa: E402
from ilqg_mujoco_tpu.physics import mjcf as jmjcf  # noqa: E402
from ilqg_mujoco_torch.models import envs  # noqa: E402
from ilqg_mujoco_torch.physics import collision, mjcf  # noqa: E402
from ilqg_mujoco_torch.physics import forward as fwd  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HOPPER = ROOT / "ilqg_mujoco_tpu" / "models" / "assets" / "hopper.xml"
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# one model per pair type; the attributes exercise the parameter
# combination (priority, solmix, condim, friction, margins and gaps)
GEOMS = {
    "plane": '<geom type="plane" size="5 5 .1" condim="3" margin="0.002" '
             'gap="0.001" friction="0.8 0.01 0.001"/>',
    "sphere": '<geom type="sphere" size="0.1" margin="0.003" solmix="2" '
              'solref="0.03 0.9" friction="1.2"/>',
    "sphere2": '<geom type="sphere" size="0.15" priority="1" condim="4" '
               'solimp="0.8 0.9 0.02 0.4 3" friction="0.5"/>',
    "capsule": '<geom type="capsule" size="0.05 0.3" solmix="0.5" '
               'solref="0.01 1.2" gap="0.0005"/>',
    "capsule2": '<geom type="capsule" size="0.08 0.2" condim="3" '
                'margin="0.001"/>',
    "box": '<geom type="box" size="0.1 0.2 0.3" friction="0.6"/>',
}
PAIRS = {
    "plane_sphere": ("plane", "sphere"),
    "plane_capsule": ("plane", "capsule"),
    "plane_box": ("plane", "box"),
    "sphere_sphere": ("sphere", "sphere2"),
    "sphere_capsule": ("sphere", "capsule"),
    "capsule_capsule": ("capsule", "capsule2"),
}


def _xml(g1, g2):
    body = lambda g: ('<body><joint type="free"/>' + GEOMS[g] + "</body>")
    first = GEOMS[g1] if g1 == "plane" else body(g1)
    return ("<mujoco><worldbody>" + first + body(g2)
            + "</worldbody></mujoco>")


def _models(xml):
    return jmjcf.load_model(xml_string=xml), mjcf.load_model(xml_string=xml)


def _frame_z(axis):
    """A rotation matrix whose z column is the unit vector ``axis``."""
    z = np.asarray(axis, float) / np.linalg.norm(axis)
    e = np.eye(3)[np.argmin(np.abs(z))]
    x = np.cross(z, e)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], -1)


def _random_poses(rng, n, ngeom):
    q = rng.standard_normal((n, ngeom, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)
    return rng.uniform(-0.3, 0.3, (n, ngeom, 3)), R


def _compare_collide(jm, m, xpos, xmat):
    """Both packages' collide on a batch of poses; returns the port's."""
    want = jax.jit(jax.vmap(lambda p, R: jcollision.collide(jm, p, R)))(
        jnp.asarray(xpos), jnp.asarray(xmat))
    got = collision.collide(m, torch.tensor(xpos), torch.tensor(xmat))
    for f in ("dist", "pos", "frame"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    # the static metadata, from one pose outside vmap
    want = jcollision.collide(jm, jnp.asarray(xpos[0]), jnp.asarray(xmat[0]))
    meta = collision.slot_meta(m)
    for f in collision.SlotMeta._fields:
        np.testing.assert_array_equal(getattr(meta, f), getattr(want, f), f)
    return got


@pytest.mark.parametrize("pair", list(PAIRS))
def test_collide_matches_jax_on_random_poses(pair):
    jm, m = _models(_xml(*PAIRS[pair]))
    rng = np.random.default_rng(sorted(PAIRS).index(pair))
    xpos, xmat = _random_poses(rng, 64, m.ngeom)
    got = _compare_collide(jm, m, xpos, xmat)
    nslot = {"plane_capsule": 2, "plane_box": 8, "capsule_capsule": 2}
    assert got.dist.shape == (64, nslot.get(pair, 1))


CAPSULE_CASES = {
    # fromto of capsule 2 against capsule 1 at -0.5 0 0 .. 0.5 0 0
    "parallel": "-0.5 0 0.15 0.5 0 0.15",
    "parallel_partial": "0.1 0 0.15 1.1 0 0.15",
    "parallel_no_overlap": "0.6 0 0.15 1.6 0 0.15",
    "antiparallel": "0.5 0 0.15 -0.5 0 0.15",
    "crossed": "0 -0.5 0.15 0 0.5 0.15",
    "near_parallel": "-0.5 0.02 0.15 0.5 -0.02 0.15",
}


def test_capsule_capsule_geometry_cases():
    """tests/test_collision_capsule.py's cases, given as poses: two slots
    in the (anti)parallel cases, the second masked otherwise."""
    xml = ("<mujoco><worldbody>"
           + "".join('<body><joint type="free"/><geom type="capsule" '
                     'size="0.1 0.5" fromto="-0.5 0 0 0.5 0 0"/></body>'
                     for _ in range(2)) + "</worldbody></mujoco>")
    jm, m = _models(xml)
    xpos, xmat = [], []
    for ft in CAPSULE_CASES.values():
        a, b = np.array(ft.split(), float).reshape(2, 3)
        xpos.append([[0.0, 0, 0], (a + b) / 2])
        xmat.append([_frame_z([1.0, 0, 0]), _frame_z(b - a)])
    got = _compare_collide(jm, m, np.array(xpos), np.array(xmat))
    masked = (got.dist[:, 1] == collision._BIG).tolist()
    assert masked == [False, False, False, False, True, True]


def test_upright_capsule_takes_the_tangent_fallback():
    """A capsule exactly normal to the plane has no in-plane axis: both
    packages fall back to mju_makeFrame's tangents, and forward-mode AD
    through the guard stays finite."""
    jm, m = _models(_xml("plane", "capsule"))
    xpos = np.array([[[0.0, 0, 0], [0.1, -0.2, 0.31]]])
    xmat = np.array([[np.eye(3), np.eye(3)]])
    got = _compare_collide(jm, m, xpos, xmat)
    np.testing.assert_allclose(got.frame[0, :, 1].numpy(),
                               [[0.0, 1, 0]] * 2, atol=0)
    # tilt the capsule infinitesimally about x: its projected axis is 0
    # at the primal, where the norm's derivative would be NaN
    tilt = torch.zeros(1, 2, 3, 3, dtype=torch.float64)
    tilt[0, 1] = torch.tensor([[0.0, 0, 0], [0, 0, -1], [0, 1, 0]])
    with fwAD.dual_level():
        R = fwAD.make_dual(torch.tensor(xmat), tilt)
        frame = collision.collide(m, torch.tensor(xpos), R).frame
        tangent = fwAD.unpack_dual(frame).tangent
    assert tangent is not None and bool(torch.isfinite(tangent).all())


@pytest.fixture(scope="module")
def hopper_states():
    """C-core hopper states at warm-in depths 0, 100 and 320, each also
    with seeded qpos/qvel perturbations: (qpos, qvel) numpy (12, 6)."""
    mm = mujoco.MjModel.from_xml_path(str(HOPPER))
    md = mujoco.MjData(mm)
    rng = np.random.default_rng(7)
    qpos, qvel, steps = [], [], 0
    for depth in (0, 100, 320):
        for _ in range(depth - steps):
            mujoco.mj_step(mm, md)
        steps = depth
        for i in range(4):
            scale = 0.0 if i == 0 else 0.02
            qpos.append(md.qpos + scale * rng.standard_normal(6))
            qvel.append(md.qvel + scale * rng.standard_normal(6))
    return np.array(qpos), np.array(qvel)


def test_hopper_rows_match_jax(hopper_states):
    qpos, qvel = hopper_states
    jm = jmjcf.load_model(str(HOPPER))
    m = envs.make("hopper").model
    pos = fwd.pos_stage(m, torch.tensor(qpos))
    want = jax.jit(jax.vmap(lambda q: jfwd.pos_stage(jm, q).efc_pos))(
        jnp.asarray(qpos))
    got = pos.efc_pos
    assert got.J.shape == (12, 44, 6)
    for f in got._fields:
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-10,
                                   atol=1e-12 * np.abs(w).max(), err_msg=f)
    # the hopper at qpos0 is 4 cm above the floor and includes no row;
    # the C-core states of depths 100 and 320 stand on the floor
    contact_rows = (got.D[:, 6:] > 0).sum(-1).tolist()
    assert contact_rows[0] == 0 and (got.D[0] == 0).all()
    assert contact_rows[4] > 0 and contact_rows[8] > 0


def _mujoco_rows(mm, md, qpos, qvel):
    """mujoco's rows at (qpos, qvel): {(kind, key): (J row, pos)} with key
    (joint, sign) for limits and (geom1, geom2, position, k) for the k-th
    row of a contact."""
    md.qpos[:], md.qvel[:] = qpos, qvel
    mujoco.mj_forward(mm, md)
    J = md.efc_J.reshape(md.nefc, mm.nv)
    rows = []
    for i in range(md.nefc):
        t, cid = int(md.efc_type[i]), int(md.efc_id[i])
        if t == int(mujoco.mjtConstraint.mjCNSTR_LIMIT_JOINT):
            rows.append((("limit", cid), J[i], md.efc_pos[i]))
        else:
            c = md.contact[cid]
            rows.append((("contact", int(c.geom1), int(c.geom2),
                          c.pos.copy()), J[i], md.efc_pos[i]))
    return rows


def test_hopper_included_rows_match_mujoco(hopper_states):
    """Every row mujoco builds is one of the port's included rows, in the
    same pyramid order, and the port includes no other: J and pos at atol
    1e-12 (the measured gap is 9e-16; the JAX package, which the port
    matches row for row above, departs from mujoco on neither)."""
    qpos, qvel = hopper_states
    m = envs.make("hopper").model
    mm = mujoco.MjModel.from_xml_path(str(HOPPER))
    md = mujoco.MjData(mm)
    pos = fwd.pos_stage(m, torch.tensor(qpos))
    efc, con = pos.efc_pos, pos.contacts
    meta = collision.slot_meta(m)
    nlim = 6
    i1 = np.flatnonzero(meta.condim == 1)
    i3 = np.flatnonzero(meta.condim >= 3)
    # the port's row index of each (slot, k-th pyramid row)
    slot_rows = {s: [nlim + r] for r, s in enumerate(i1)}
    for r, s in enumerate(i3):
        slot_rows[s] = [nlim + len(i1) + g * len(i3) + r for g in range(4)]
    lim_joint = [j for j in range(m.njnt) if m.jnt_limited[j]]
    geom_pair = list(zip(m.pair_geom1.repeat(2), m.pair_geom2.repeat(2)))
    for b in range(len(qpos)):
        inc = set(np.flatnonzero(efc.D[b].numpy() > 0))
        seen, k_of = set(), {}
        for key, Jrow, p in _mujoco_rows(mm, md, qpos[b], qvel[b]):
            if key[0] == "limit":
                side = 0 if Jrow[m.jnt_dofadr[key[1]]] > 0 else 1
                r = 2 * lim_joint.index(key[1]) + side
            else:
                slot = min((s for s in range(len(geom_pair))
                            if geom_pair[s] == key[1:3]),
                           key=lambda s: np.abs(con.pos[b, s].numpy()
                                                - key[3]).max())
                k = k_of.get(slot, 0)
                k_of[slot] = k + 1
                r = slot_rows[slot][k]
            np.testing.assert_allclose(efc.J[b, r].numpy(), Jrow, atol=1e-12)
            np.testing.assert_allclose(efc.pos[b, r].item(), p, atol=1e-12)
            seen.add(r)
        assert seen == inc, (b, sorted(seen), sorted(inc))
