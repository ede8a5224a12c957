"""MJCF model compiler: XML -> static :class:`Model`.

Replaces the reference's reliance on ``mj_loadXML``
(reference cmd/basic.cpp:123).  Supports the MJCF subset exercised by the
three reference assets (res/inverted_pendulum.xml, res/hopper.xml,
res/humanoid.xml):

* ``<compiler angle coordinate inertiafromgeom>`` including the legacy
  ``coordinate="global"`` mode (hopper) that modern MuJoCo refuses to load;
* ``<default>`` single-level defaults for joint/geom/motor;
* joints: free/ball/slide/hinge with ref/range/armature/damping/stiffness;
* geoms: plane/sphere/capsule/box/cylinder with fromto, inertia-from-geom
  (density) mass properties;
* ``<actuator><motor>`` joint transmissions with gear/ctrlrange;
* ``<option>`` incl. solver override fields (o_solref/o_solimp + flags).

Compiled arrays use mjModel naming so tests can diff against the ``mujoco``
python bindings (tests/test_mjcf_parity.py).

This is the PyTorch package's own copy of ``ilqg_mujoco_tpu/physics/mjcf.py``
(numpy only); it builds the port's :class:`Model`, and
tests/test_torch_physics.py asserts that both copies compile the same arrays.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from .model import (
    CONE_ELLIPTIC,
    CONE_PYRAMIDAL,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_PLANE,
    GEOM_SPHERE,
    INT_EULER,
    INT_RK4,
    JNT_BALL,
    JNT_FREE,
    JNT_HINGE,
    JNT_NQ,
    JNT_NV,
    JNT_SLIDE,
    Model,
    Option,
)

_GEOM_TYPES = {
    "plane": GEOM_PLANE,
    "sphere": GEOM_SPHERE,
    "capsule": GEOM_CAPSULE,
    "cylinder": GEOM_CYLINDER,
    "box": GEOM_BOX,
}
_JNT_TYPES = {"free": JNT_FREE, "ball": JNT_BALL, "slide": JNT_SLIDE,
              "hinge": JNT_HINGE}

# maximum number of contact points generated per geom-type pair
_PAIR_MAXCON = {
    (GEOM_PLANE, GEOM_SPHERE): 1,
    (GEOM_PLANE, GEOM_CAPSULE): 2,
    (GEOM_PLANE, GEOM_BOX): 8,   # 8 masked corner slots (MuJoCo emits <= 4)
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_CAPSULE, GEOM_CAPSULE): 2,
}


def _fnum(tok: str) -> float:
    """Lenient float parse: also evaluates simple 'a/b' division, which the
    reference hopper asset uses (pos="0.13/2 ...",
    reference res/hopper.xml:24)."""
    if "/" in tok:
        a, b = tok.split("/")
        return float(a) / float(b)
    return float(tok)


def _floats(s: str) -> List[float]:
    return [_fnum(t) for t in s.split()]


def _vec(s: Optional[str], default: List[float], n: Optional[int] = None):
    if s is None:
        v = list(default)
    else:
        v = _floats(s)
    if n is not None:
        if len(v) < n:
            v = v + list(default[len(v):n])
        v = v[:n]
    return np.array(v, dtype=np.float64)


def _quat_mul(q, p):
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = p
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _norm_quat(q):
    return q / np.linalg.norm(q)


def _z_align_quat(vec):
    """Quaternion rotating +z onto unit vector vec (MuJoCo fromto handling)."""
    z = np.array([0.0, 0.0, 1.0])
    v = vec / np.linalg.norm(vec)
    c = float(np.dot(z, v))
    if c > 1 - 1e-14:
        return np.array([1.0, 0.0, 0.0, 0.0])
    if c < -1 + 1e-14:
        return np.array([0.0, 1.0, 0.0, 0.0])  # 180deg about x
    axis = np.cross(z, v)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * math.acos(max(-1.0, min(1.0, c)))
    return np.array([math.cos(half), *(math.sin(half) * axis)])


def _mat_to_quat(R):
    tr = np.trace(R)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = math.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = math.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = math.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    return _norm_quat(q)


def _geom_mass_inertia(gtype, size, density):
    """Geom mass + principal inertia about its own frame (MuJoCo
    inertiafromgeom formulas)."""
    pi = math.pi
    if gtype == GEOM_SPHERE:
        r = size[0]
        m = density * 4.0 / 3.0 * pi * r ** 3
        i = 2.0 / 5.0 * m * r * r
        return m, np.array([i, i, i])
    if gtype == GEOM_CAPSULE:
        r, hl = size[0], size[1]
        h = 2 * hl
        ms = density * 4.0 / 3.0 * pi * r ** 3
        mc = density * pi * r * r * h
        m = ms + mc
        iz = 2.0 / 5.0 * ms * r * r + 0.5 * mc * r * r
        ix = (2.0 / 5.0 * ms * r * r
              + mc * (3 * r * r + h * h) / 12.0
              + ms * (h * h / 4.0 + 3.0 * h * r / 8.0))
        return m, np.array([ix, ix, iz])
    if gtype == GEOM_CYLINDER:
        r, hl = size[0], size[1]
        h = 2 * hl
        m = density * pi * r * r * h
        iz = 0.5 * m * r * r
        ix = m * (3 * r * r + h * h) / 12.0
        return m, np.array([ix, ix, iz])
    if gtype == GEOM_BOX:
        sx, sy, sz = size
        m = density * 8.0 * sx * sy * sz
        return m, m / 3.0 * np.array(
            [sy * sy + sz * sz, sx * sx + sz * sz, sx * sx + sy * sy])
    # plane / other: massless
    return 0.0, np.zeros(3)


class _Defaults:
    """Single-inheritance default classes (<default> tree)."""

    def __init__(self, parent: Optional["_Defaults"] = None):
        self.joint: Dict[str, str] = dict(parent.joint) if parent else {}
        self.geom: Dict[str, str] = dict(parent.geom) if parent else {}
        self.motor: Dict[str, str] = dict(parent.motor) if parent else {}
        self.children: Dict[str, "_Defaults"] = {}

    @staticmethod
    def parse(elem: ET.Element, parent: Optional["_Defaults"] = None):
        d = _Defaults(parent)
        for child in elem:
            if child.tag in ("joint", "geom", "motor", "position", "general"):
                tgt = getattr(d, "motor" if child.tag != "joint" and
                              child.tag != "geom" else child.tag)
                if child.tag == "joint":
                    tgt = d.joint
                elif child.tag == "geom":
                    tgt = d.geom
                else:
                    tgt = d.motor
                tgt.update(child.attrib)
            elif child.tag == "default":
                name = child.get("class", "")
                d.children[name] = _Defaults.parse(child, d)
        return d


def _attr(elem: ET.Element, dflt: Dict[str, str], key: str,
          fallback: Optional[str] = None) -> Optional[str]:
    v = elem.get(key)
    if v is not None:
        return v
    if key in dflt:
        return dflt[key]
    return fallback


def load_model(path: Optional[str] = None, xml_string: Optional[str] = None,
               ) -> Model:
    if xml_string is None:
        with open(path) as f:
            xml_string = f.read()
    root = ET.fromstring(xml_string)
    assert root.tag == "mujoco"
    name = root.get("model", "model")

    # ---- compiler -------------------------------------------------------
    comp = root.find("compiler")
    angle = "degree"
    coordinate = "local"
    density_default = 1000.0
    if comp is not None:
        angle = comp.get("angle", angle)
        coordinate = comp.get("coordinate", coordinate)
    ang_scale = math.pi / 180.0 if angle == "degree" else 1.0
    global_coords = coordinate == "global"

    # ---- defaults -------------------------------------------------------
    defaults = _Defaults()
    delem = root.find("default")
    if delem is not None:
        defaults = _Defaults.parse(delem)

    # ---- option ---------------------------------------------------------
    oelem = root.find("option")
    okw = {}
    if oelem is not None:
        okw["timestep"] = float(oelem.get("timestep", 0.002))
        okw["gravity"] = tuple(_vec(oelem.get("gravity"), [0, 0, -9.81], 3))
        integ = oelem.get("integrator", "Euler")
        okw["integrator"] = INT_RK4 if integ == "RK4" else INT_EULER
        okw["iterations"] = int(oelem.get("iterations", 100))
        okw["tolerance"] = float(oelem.get("tolerance", 1e-8))
        okw["impratio"] = float(oelem.get("impratio", 1.0))
        okw["cone"] = (CONE_ELLIPTIC if oelem.get("cone") == "elliptic"
                       else CONE_PYRAMIDAL)
        if oelem.get("o_solref"):
            okw["o_solref"] = tuple(_vec(oelem.get("o_solref"), [0.02, 1], 2))
        if oelem.get("o_solimp"):
            okw["o_solimp"] = tuple(
                _vec(oelem.get("o_solimp"), [0.9, 0.95, 0.001, 0.5, 2.0], 5))
        flag = oelem.find("flag")
        if flag is not None:
            okw["override_active"] = flag.get("override") == "enable"
            okw["disable_contact"] = flag.get("contact") == "disable"
            okw["disable_limit"] = flag.get("limit") == "disable"
            okw["disable_gravity"] = flag.get("gravity") == "disable"
            okw["disable_clampctrl"] = flag.get("clampctrl") == "disable"
            okw["disable_eulerdamp"] = flag.get("eulerdamp") == "disable"
    option = Option(**okw)

    # ---- accumulators ---------------------------------------------------
    bodies = {
        "parentid": [0], "pos": [np.zeros(3)], "quat": [np.array([1., 0, 0, 0])],
        "name": ["world"],
    }
    joints: List[dict] = []
    geoms: List[dict] = []
    body_geoms: Dict[int, List[int]] = {0: []}
    body_explicit_inertia: Dict[int, dict] = {}
    joint_names: Dict[str, int] = {}

    def parse_geom(elem, bodyid, xpos_body, xquat_body):
        dflt = defaults.geom
        gtype_name = _attr(elem, dflt, "type", "sphere")
        if gtype_name not in _GEOM_TYPES:
            raise ValueError(
                f"unsupported geom type '{gtype_name}' (supported: "
                f"{sorted(_GEOM_TYPES)})")
        gtype = _GEOM_TYPES[gtype_name]
        size = _vec(_attr(elem, dflt, "size", "0 0 0"), [0, 0, 0], 3)
        fromto = _attr(elem, dflt, "fromto")
        pos = _vec(_attr(elem, dflt, "pos", "0 0 0"), [0, 0, 0], 3)
        quat = _norm_quat(_vec(_attr(elem, dflt, "quat", "1 0 0 0"),
                               [1, 0, 0, 0], 4))
        if fromto is not None:
            ft = _floats(fromto)
            p0, p1 = np.array(ft[:3]), np.array(ft[3:6])
            pos = 0.5 * (p0 + p1)
            d = p1 - p0
            quat = _z_align_quat(d)
            size = np.array([size[0], 0.5 * np.linalg.norm(d), 0.0])
        if global_coords:
            # convert geom frame from global to body-local
            Rb = _quat_to_mat(xquat_body)
            pos = Rb.T @ (pos - xpos_body)
            quat = _quat_mul(
                np.array([xquat_body[0], *(-xquat_body[1:])]), quat)
        g = dict(
            type=gtype, bodyid=bodyid, pos=pos, quat=_norm_quat(quat),
            size=size,
            friction=_vec(_attr(elem, dflt, "friction", "1 0.005 0.0001"),
                          [1, 0.005, 0.0001], 3),
            contype=int(_attr(elem, dflt, "contype", "1")),
            conaffinity=int(_attr(elem, dflt, "conaffinity", "1")),
            condim=int(_attr(elem, dflt, "condim", "3")),
            margin=float(_attr(elem, dflt, "margin", "0")),
            gap=float(_attr(elem, dflt, "gap", "0")),
            solref=_vec(_attr(elem, dflt, "solref", "0.02 1"), [0.02, 1], 2),
            solimp=_vec(_attr(elem, dflt, "solimp", "0.9 0.95 0.001 0.5 2"),
                        [0.9, 0.95, 0.001, 0.5, 2.0], 5),
            solmix=float(_attr(elem, dflt, "solmix", "1")),
            priority=int(_attr(elem, dflt, "priority", "0")),
            density=float(_attr(elem, dflt, "density", "1000")),
            mass=_attr(elem, dflt, "mass"),
        )
        geoms.append(g)
        body_geoms[bodyid].append(len(geoms) - 1)

    def parse_joint(elem, bodyid, xpos_body, xquat_body, is_free=False):
        dflt = {} if is_free else defaults.joint
        jtype = (JNT_FREE if is_free else
                 _JNT_TYPES[_attr(elem, dflt, "type", "hinge")])
        pos = _vec(_attr(elem, dflt, "pos", "0 0 0"), [0, 0, 0], 3)
        axis = _vec(_attr(elem, dflt, "axis", "0 0 1"), [0, 0, 1], 3)
        if global_coords:
            Rb = _quat_to_mat(xquat_body)
            pos = Rb.T @ (pos - xpos_body)
            axis = Rb.T @ axis
        nrm = np.linalg.norm(axis)
        if nrm > 0:
            axis = axis / nrm
        rng = _vec(_attr(elem, dflt, "range", "0 0"), [0, 0], 2)
        limited_s = _attr(elem, dflt, "limited")
        # "auto" semantics: limited iff range given and limited not "false"
        if limited_s is None:
            limited = bool(np.any(rng != 0))
        else:
            limited = limited_s == "true"
        if jtype in (JNT_HINGE, JNT_BALL):
            rng = rng * ang_scale
        ref = float(_attr(elem, dflt, "ref", "0"))
        if jtype == JNT_HINGE:
            ref = ref * ang_scale
        springref = float(_attr(elem, dflt, "springref", "0"))
        if jtype == JNT_HINGE:
            springref = springref * ang_scale
        j = dict(
            type=jtype, bodyid=bodyid, pos=pos, axis=axis, range=rng,
            limited=limited and jtype != JNT_FREE,
            stiffness=float(_attr(elem, dflt, "stiffness", "0")),
            armature=float(_attr(elem, dflt, "armature", "0")),
            damping=float(_attr(elem, dflt, "damping", "0")),
            frictionloss=float(_attr(elem, dflt, "frictionloss", "0")),
            margin=float(_attr(elem, dflt, "margin", "0")),
            solref=_vec(_attr(elem, dflt, "solreflimit", "0.02 1"),
                        [0.02, 1], 2),
            solimp=_vec(_attr(elem, dflt, "solimplimit",
                              "0.9 0.95 0.001 0.5 2"),
                        [0.9, 0.95, 0.001, 0.5, 2.0], 5),
            ref=ref, springref=springref,
            name=elem.get("name", f"joint{len(joints)}"),
        )
        joint_names[j["name"]] = len(joints)
        joints.append(j)

    def parse_body(elem, parentid, parent_xpos, parent_xquat):
        pos = _vec(elem.get("pos"), [0, 0, 0], 3)
        quat = _norm_quat(_vec(elem.get("quat"), [1, 0, 0, 0], 4))
        if global_coords:
            # attributes are global: local = relative to parent frame
            xpos, xquat = pos, quat
            Rp = _quat_to_mat(parent_xquat)
            lpos = Rp.T @ (xpos - parent_xpos)
            lquat = _quat_mul(
                np.array([parent_xquat[0], *(-parent_xquat[1:])]), quat)
        else:
            lpos, lquat = pos, quat
            Rp = _quat_to_mat(parent_xquat)
            xpos = parent_xpos + Rp @ lpos
            xquat = _quat_mul(parent_xquat, quat)
        bodies["parentid"].append(parentid)
        bodies["pos"].append(lpos)
        bodies["quat"].append(_norm_quat(lquat))
        bodies["name"].append(elem.get("name", f"body{len(bodies['pos'])}"))
        bid = len(bodies["pos"]) - 1
        body_geoms[bid] = []
        for child in elem:
            if child.tag == "geom":
                parse_geom(child, bid, xpos, xquat)
            elif child.tag == "joint":
                parse_joint(child, bid, xpos, xquat)
            elif child.tag == "freejoint":
                parse_joint(child, bid, xpos, xquat, is_free=True)
            elif child.tag == "inertial":
                body_explicit_inertia[bid] = dict(
                    pos=_vec(child.get("pos"), [0, 0, 0], 3),
                    quat=_norm_quat(_vec(child.get("quat"), [1, 0, 0, 0], 4)),
                    mass=float(child.get("mass")),
                    diaginertia=_vec(child.get("diaginertia"), [0, 0, 0], 3),
                )
            elif child.tag == "body":
                parse_body(child, bid, xpos, xquat)
            # lights / cameras / sites ignored

    world = root.find("worldbody")
    for child in world:
        if child.tag == "geom":
            parse_geom(child, 0, np.zeros(3), np.array([1., 0, 0, 0]))
        elif child.tag == "body":
            parse_body(child, 0, np.zeros(3), np.array([1., 0, 0, 0]))

    nbody = len(bodies["pos"])
    njnt = len(joints)
    ngeom = len(geoms)

    # ---- inertial properties -------------------------------------------
    body_mass = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_inertia = np.zeros((nbody, 3))
    for b in range(1, nbody):
        if b in body_explicit_inertia:
            ei = body_explicit_inertia[b]
            body_mass[b] = ei["mass"]
            body_ipos[b] = ei["pos"]
            body_iquat[b] = ei["quat"]
            body_inertia[b] = ei["diaginertia"]
            continue
        gm, gc, gI = [], [], []
        for gi in body_geoms.get(b, []):
            g = geoms[gi]
            m, Idiag = _geom_mass_inertia(g["type"], g["size"], g["density"])
            if g["mass"] is not None and m > 0:
                scale = float(g["mass"]) / m
                m, Idiag = float(g["mass"]), Idiag * scale
            R = _quat_to_mat(g["quat"])
            gm.append(m)
            gc.append(g["pos"])
            gI.append(R @ np.diag(Idiag) @ R.T)
        M = sum(gm)
        if M <= 0:
            continue
        com = sum(m * c for m, c in zip(gm, gc)) / M
        Itot = np.zeros((3, 3))
        for m, c, I in zip(gm, gc, gI):
            d = c - com
            Itot += I + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        w, V = np.linalg.eigh(Itot)
        # descending eigenvalues, right-handed frame (MuJoCo convention)
        order = np.argsort(w)[::-1]
        w, V = w[order], V[:, order]
        if np.linalg.det(V) < 0:
            V[:, 2] *= -1
        body_mass[b] = M
        body_ipos[b] = com
        body_iquat[b] = _mat_to_quat(V)
        body_inertia[b] = w

    # ---- joint/dof arrays ----------------------------------------------
    jnt_type = np.array([j["type"] for j in joints], dtype=np.int32)
    jnt_bodyid = np.array([j["bodyid"] for j in joints], dtype=np.int32)
    jnt_qposadr = np.zeros(njnt, dtype=np.int32)
    jnt_dofadr = np.zeros(njnt, dtype=np.int32)
    nq = nv = 0
    for i, j in enumerate(joints):
        jnt_qposadr[i] = nq
        jnt_dofadr[i] = nv
        nq += JNT_NQ[j["type"]]
        nv += JNT_NV[j["type"]]
    dof_bodyid = np.zeros(nv, dtype=np.int32)
    dof_jntid = np.zeros(nv, dtype=np.int32)
    dof_armature = np.zeros(nv)
    dof_damping = np.zeros(nv)
    dof_frictionloss = np.zeros(nv)
    qpos0 = np.zeros(nq)
    qpos_spring = np.zeros(nq)
    for i, j in enumerate(joints):
        da, qa = jnt_dofadr[i], jnt_qposadr[i]
        w = JNT_NV[j["type"]]
        dof_bodyid[da:da + w] = j["bodyid"]
        dof_jntid[da:da + w] = i
        dof_armature[da:da + w] = j["armature"]
        dof_damping[da:da + w] = j["damping"]
        dof_frictionloss[da:da + w] = j["frictionloss"]
        if j["type"] in (JNT_SLIDE, JNT_HINGE):
            qpos0[qa] = j["ref"]
            qpos_spring[qa] = j["springref"]
        elif j["type"] == JNT_BALL:
            qpos0[qa] = 1.0          # identity quat
            qpos_spring[qa] = 1.0
        elif j["type"] == JNT_FREE:
            qpos0[qa + 3] = 1.0
            qpos_spring[qa + 3] = 1.0

    # reference global pose (no joint motion): needed for free-joint qpos0
    # (MuJoCo stores the body's global reference pose there) and invweight0
    nbody_ = len(bodies["pos"])
    ref_xpos = np.zeros((nbody_, 3))
    ref_xquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody_, 1))
    for b in range(1, nbody_):
        p = bodies["parentid"][b]
        Rp = _quat_to_mat(ref_xquat[p])
        ref_xpos[b] = ref_xpos[p] + Rp @ bodies["pos"][b]
        ref_xquat[b] = _norm_quat(_quat_mul(ref_xquat[p], bodies["quat"][b]))
    for i, j in enumerate(joints):
        if j["type"] == JNT_FREE:
            qa = jnt_qposadr[i]
            qpos0[qa:qa + 3] = ref_xpos[j["bodyid"]]
            qpos0[qa + 3:qa + 7] = ref_xquat[j["bodyid"]]
            qpos_spring[qa:qa + 7] = qpos0[qa:qa + 7]

    # ---- actuators ------------------------------------------------------
    act_elem = root.find("actuator")
    motors = []
    if act_elem is not None:
        for a in act_elem:
            if a.tag != "motor":
                continue
            dflt = defaults.motor
            jname = _attr(a, dflt, "joint")
            gear = _vec(_attr(a, dflt, "gear", "1"), [1], 1)[0]
            crange = _vec(_attr(a, dflt, "ctrlrange", "0 0"), [0, 0], 2)
            cl = _attr(a, dflt, "ctrllimited")
            climited = (bool(np.any(crange != 0)) if cl is None
                        else cl == "true")
            motors.append(dict(jid=joint_names[jname], gear=gear,
                               ctrlrange=crange, ctrllimited=climited))
    nu = len(motors)

    # ---- collision pairs -------------------------------------------------
    gtype = np.array([g["type"] for g in geoms], dtype=np.int32)
    gbody = np.array([g["bodyid"] for g in geoms], dtype=np.int32)
    gcontype = np.array([g["contype"] for g in geoms], dtype=np.int32)
    gconaff = np.array([g["conaffinity"] for g in geoms], dtype=np.int32)
    parentid = np.array(bodies["parentid"], dtype=np.int32)
    pair1, pair2 = [], []
    for g1 in range(ngeom):
        for g2 in range(g1 + 1, ngeom):
            b1, b2 = gbody[g1], gbody[g2]
            if b1 == b2:
                continue
            # exclude parent-child unless parent is world
            if (parentid[b2] == b1 and b1 != 0) or \
               (parentid[b1] == b2 and b2 != 0):
                continue
            if not ((gcontype[g1] & gconaff[g2]) or
                    (gcontype[g2] & gconaff[g1])):
                continue
            t1, t2 = int(gtype[g1]), int(gtype[g2])
            key = (min(t1, t2), max(t1, t2))
            if key not in _PAIR_MAXCON:
                continue
            # order pair so the lower type id comes first (plane first)
            if t1 <= t2:
                pair1.append(g1)
                pair2.append(g2)
            else:
                pair1.append(g2)
                pair2.append(g1)

    model = Model(
        nq=nq, nv=nv, nu=nu, nbody=nbody, njnt=njnt, ngeom=ngeom,
        opt=option,
        body_parentid=parentid,
        body_pos=np.array(bodies["pos"]),
        body_quat=np.array(bodies["quat"]),
        body_ipos=body_ipos, body_iquat=body_iquat,
        body_mass=body_mass, body_inertia=body_inertia,
        jnt_type=jnt_type, jnt_bodyid=jnt_bodyid,
        jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
        jnt_pos=np.array([j["pos"] for j in joints]).reshape(njnt, 3),
        jnt_axis=np.array([j["axis"] for j in joints]).reshape(njnt, 3),
        jnt_limited=np.array([j["limited"] for j in joints], dtype=bool),
        jnt_range=np.array([j["range"] for j in joints]).reshape(njnt, 2),
        jnt_stiffness=np.array([j["stiffness"] for j in joints]),
        jnt_margin=np.array([j["margin"] for j in joints]),
        jnt_solref=np.array([j["solref"] for j in joints]).reshape(njnt, 2),
        jnt_solimp=np.array([j["solimp"] for j in joints]).reshape(njnt, 5),
        qpos_spring=qpos_spring, qpos0=qpos0,
        dof_bodyid=dof_bodyid, dof_jntid=dof_jntid,
        dof_armature=dof_armature, dof_damping=dof_damping,
        dof_frictionloss=dof_frictionloss,
        geom_type=gtype, geom_bodyid=gbody,
        geom_pos=np.array([g["pos"] for g in geoms]).reshape(ngeom, 3),
        geom_quat=np.array([g["quat"] for g in geoms]).reshape(ngeom, 4),
        geom_size=np.array([g["size"] for g in geoms]).reshape(ngeom, 3),
        geom_friction=np.array([g["friction"] for g in geoms]
                               ).reshape(ngeom, 3),
        geom_contype=gcontype, geom_conaffinity=gconaff,
        geom_condim=np.array([g["condim"] for g in geoms], dtype=np.int32),
        geom_margin=np.array([g["margin"] for g in geoms]),
        geom_gap=np.array([g["gap"] for g in geoms]),
        geom_solref=np.array([g["solref"] for g in geoms]).reshape(ngeom, 2),
        geom_solimp=np.array([g["solimp"] for g in geoms]).reshape(ngeom, 5),
        geom_solmix=np.array([g["solmix"] for g in geoms]),
        geom_priority=np.array([g["priority"] for g in geoms],
                               dtype=np.int32),
        actuator_trnid=np.array([m["jid"] for m in motors], dtype=np.int32),
        actuator_gear=np.array([m["gear"] for m in motors]),
        actuator_ctrllimited=np.array([m["ctrllimited"] for m in motors],
                                      dtype=bool),
        actuator_ctrlrange=np.array([m["ctrlrange"] for m in motors]
                                    ).reshape(nu, 2),
        pair_geom1=np.array(pair1, dtype=np.int32),
        pair_geom2=np.array(pair2, dtype=np.int32),
        dof_invweight0=np.zeros(nv),
        body_invweight0=np.zeros((nbody, 2)),
        name=name,
    )
    dof_iw, body_iw = _invweight0(model, ref_xpos, ref_xquat, body_mass,
                                  body_ipos, body_iquat, body_inertia)
    object.__setattr__(model, "dof_invweight0", dof_iw)
    object.__setattr__(model, "body_invweight0", body_iw)
    return model


def _invweight0(model: Model, xpos, xquat, body_mass, body_ipos, body_iquat,
                body_inertia):
    """Compile-time inverse-inertia weights at qpos0 (mj_setConst analog).

    At qpos0 every joint transform is the identity, so the reference global
    pose xpos/xquat IS the kinematics — a small numpy computation."""
    nv, nbody = model.nv, model.nbody
    # dof motion axes at qpos0 (world-origin Plücker, angular-first)
    S = np.zeros((nv, 6))
    for j in range(model.njnt):
        jt = int(model.jnt_type[j])
        b = int(model.jnt_bodyid[j])
        da = int(model.jnt_dofadr[j])
        R = _quat_to_mat(xquat[b])
        if jt == JNT_FREE:
            for k in range(3):
                S[da + k, 3 + k] = 1.0
            for k in range(3):
                w = R[:, k]
                S[da + 3 + k, :3] = w
                S[da + 3 + k, 3:] = np.cross(xpos[b], w)
        elif jt == JNT_BALL:
            anchor = xpos[b] + R @ model.jnt_pos[j]
            for k in range(3):
                w = R[:, k]
                S[da + k, :3] = w
                S[da + k, 3:] = np.cross(anchor, w)
        else:
            anchor = xpos[b] + R @ model.jnt_pos[j]
            axis = R @ model.jnt_axis[j]
            if jt == JNT_SLIDE:
                S[da, 3:] = axis
            else:
                S[da, :3] = axis
                S[da, 3:] = np.cross(anchor, axis)
    # spatial inertia per body, mass matrix
    M = np.diag(model.dof_armature.astype(np.float64).copy())
    coms = np.zeros((nbody, 3))
    for b in range(1, nbody):
        R = _quat_to_mat(xquat[b])
        Ri = R @ _quat_to_mat(body_iquat[b])
        com = xpos[b] + R @ body_ipos[b]
        coms[b] = com
        Ic = Ri @ np.diag(body_inertia[b]) @ Ri.T
        m_ = body_mass[b]
        sc = np.array([[0, -com[2], com[1]], [com[2], 0, -com[0]],
                       [-com[1], com[0], 0]])
        I6 = np.zeros((6, 6))
        I6[:3, :3] = Ic + m_ * sc @ sc.T
        I6[:3, 3:] = m_ * sc
        I6[3:, :3] = m_ * sc.T
        I6[3:, 3:] = m_ * np.eye(3)
        mask = model.dof_mask[b]
        SB = mask[:, None] * S
        M += SB @ I6 @ SB.T
    Minv = np.linalg.inv(M) if nv else np.zeros((0, 0))
    dof_iw = np.diag(Minv).copy() if nv else np.zeros(0)
    # MuJoCo averages invweights within multi-dof joints: free joints over the
    # translation and rotation triples separately, ball joints over all 3
    for j in range(model.njnt):
        jt, da = int(model.jnt_type[j]), int(model.jnt_dofadr[j])
        if jt == JNT_FREE:
            dof_iw[da:da + 3] = dof_iw[da:da + 3].mean()
            dof_iw[da + 3:da + 6] = dof_iw[da + 3:da + 6].mean()
        elif jt == JNT_BALL:
            dof_iw[da:da + 3] = dof_iw[da:da + 3].mean()
    body_iw = np.zeros((nbody, 2))
    for b in range(1, nbody):
        mask = model.dof_mask[b]
        Jt = (mask[:, None] * (S[:, 3:] + np.cross(S[:, :3], coms[b]))).T
        Jr = (mask[:, None] * S[:, :3]).T
        At = Jt @ Minv @ Jt.T
        Ar = Jr @ Minv @ Jr.T
        body_iw[b, 0] = np.trace(At) / 3.0
        body_iw[b, 1] = np.trace(Ar) / 3.0
    return dof_iw, body_iw
