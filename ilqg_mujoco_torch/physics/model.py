"""Static model description and the batched dynamic state.

* :class:`Model` is the same frozen host-side record of numpy arrays the JAX
  package compiles (``ilqg_mujoco_tpu/physics/model.py``), copied here so the
  port never imports that package.  :func:`device_arrays` uploads its float
  arrays once per (model, device, dtype).
* :class:`State` is the ``cpMjData`` subset (reference src/util.cpp:4-14)
  as a dataclass of tensors with leading batch dims: ``qpos`` is
  ``(..., nq)``, ``time`` is ``(...)``.  A trajectory of a batch is
  ``(B, T, ...)``.

Joint/geom type enums match MuJoCo's values.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

# MuJoCo enum values (mjtJoint / mjtGeom / mjtIntegrator / mjtCone)
JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE = 0, 1, 2, 3
GEOM_PLANE, GEOM_SPHERE, GEOM_CAPSULE, GEOM_ELLIPSOID, GEOM_CYLINDER, GEOM_BOX = (
    0, 2, 3, 4, 5, 6)
INT_EULER, INT_RK4 = 0, 1
CONE_PYRAMIDAL, CONE_ELLIPTIC = 0, 1

# dofs/qpos widths per joint type
JNT_NV = {JNT_FREE: 6, JNT_BALL: 3, JNT_SLIDE: 1, JNT_HINGE: 1}
JNT_NQ = {JNT_FREE: 7, JNT_BALL: 4, JNT_SLIDE: 1, JNT_HINGE: 1}


@dataclasses.dataclass(frozen=True)
class Option:
    """Simulation options (MJCF <option>), reference defaults.

    ``iterations``/``tolerance`` mirror the solver pinning the FD engine relies
    on (reference src/mjderivative.cpp:241-242)."""
    timestep: float = 0.002
    gravity: tuple = (0.0, 0.0, -9.81)
    integrator: int = INT_EULER
    iterations: int = 100
    tolerance: float = 1e-8
    ls_iterations: int = 50
    cone: int = CONE_PYRAMIDAL
    impratio: float = 1.0
    # constraint overrides (<option o_solref o_solimp> + <flag override>)
    override_active: bool = False
    o_solref: tuple = (0.02, 1.0)
    o_solimp: tuple = (0.9, 0.95, 0.001, 0.5, 2.0)
    o_margin: float = 0.0
    disable_contact: bool = False
    disable_limit: bool = False
    disable_gravity: bool = False
    disable_clampctrl: bool = False
    disable_eulerdamp: bool = False


@dataclasses.dataclass(frozen=True)
class Model:
    """Compiled model: numpy arrays, host-resident, hashable by identity.

    Field names follow mjModel."""
    # sizes
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int

    opt: Option

    # bodies
    body_parentid: np.ndarray   # (nbody,) int
    body_pos: np.ndarray        # (nbody,3)
    body_quat: np.ndarray       # (nbody,4)
    body_ipos: np.ndarray       # (nbody,3)
    body_iquat: np.ndarray      # (nbody,4)
    body_mass: np.ndarray       # (nbody,)
    body_inertia: np.ndarray    # (nbody,3)

    # joints
    jnt_type: np.ndarray        # (njnt,) int
    jnt_bodyid: np.ndarray      # (njnt,) int
    jnt_qposadr: np.ndarray     # (njnt,) int
    jnt_dofadr: np.ndarray      # (njnt,) int
    jnt_pos: np.ndarray         # (njnt,3) local
    jnt_axis: np.ndarray        # (njnt,3) local
    jnt_limited: np.ndarray     # (njnt,) bool
    jnt_range: np.ndarray       # (njnt,2)
    jnt_stiffness: np.ndarray   # (njnt,)
    jnt_margin: np.ndarray      # (njnt,)
    jnt_solref: np.ndarray      # (njnt,2)
    jnt_solimp: np.ndarray      # (njnt,5)
    qpos_spring: np.ndarray     # (nq,)
    qpos0: np.ndarray           # (nq,)

    # dofs
    dof_bodyid: np.ndarray      # (nv,) int
    dof_jntid: np.ndarray       # (nv,) int
    dof_armature: np.ndarray    # (nv,)
    dof_damping: np.ndarray     # (nv,)
    dof_frictionloss: np.ndarray  # (nv,)

    # geoms
    geom_type: np.ndarray       # (ngeom,) int
    geom_bodyid: np.ndarray     # (ngeom,) int
    geom_pos: np.ndarray        # (ngeom,3)
    geom_quat: np.ndarray       # (ngeom,4)
    geom_size: np.ndarray       # (ngeom,3)
    geom_friction: np.ndarray   # (ngeom,3)
    geom_contype: np.ndarray    # (ngeom,) int
    geom_conaffinity: np.ndarray  # (ngeom,) int
    geom_condim: np.ndarray     # (ngeom,) int
    geom_margin: np.ndarray     # (ngeom,)
    geom_gap: np.ndarray        # (ngeom,)
    geom_solref: np.ndarray     # (ngeom,2)
    geom_solimp: np.ndarray     # (ngeom,5)
    geom_solmix: np.ndarray     # (ngeom,)
    geom_priority: np.ndarray   # (ngeom,) int

    # actuators (motor/joint transmission only)
    actuator_trnid: np.ndarray      # (nu,) joint id
    actuator_gear: np.ndarray       # (nu,)
    actuator_ctrllimited: np.ndarray  # (nu,) bool
    actuator_ctrlrange: np.ndarray  # (nu,2)

    # precomputed candidate contact pairs (static collision lists)
    pair_geom1: np.ndarray      # (npair,) int
    pair_geom2: np.ndarray      # (npair,) int

    # compile-time constraint weights at qpos0 (mj_setConst analogs)
    dof_invweight0: np.ndarray = None   # (nv,)
    body_invweight0: np.ndarray = None  # (nbody,2) [translation, rotation]

    name: str = "model"

    def __post_init__(self):
        # ancestor mask: anc[b, a] = 1 if body a is ancestor-of-or-equal b
        anc = np.zeros((self.nbody, self.nbody), dtype=np.float64)
        for b in range(self.nbody):
            a = b
            while a != 0:
                anc[b, a] = 1.0
                a = int(self.body_parentid[a])
        # world (body 0) is never counted: it carries no dofs
        object.__setattr__(self, "ancestor_mask", anc)
        # dof mask: dofmask[b, i] = 1 if dof i moves body b
        dm = anc[:, self.dof_bodyid]  # (nbody, nv)
        object.__setattr__(self, "dof_mask", dm)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  The CPU runs only when asked for by name;
    asking for CUDA where there is none raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


_ON_DEVICE: dict = {}


def on_device(model: Model, device, dtype, build):
    """``build(model, device, dtype)`` computed once per (model, build,
    device, dtype): the model's constants go to the device once.  The key
    holds the model itself (identity hash), so an entry can never be served
    to another model."""
    dev = torch.device(device)
    key = (model, build, str(dev), dtype)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = build(model, dev, dtype)
    return _ON_DEVICE[key]


# float arrays that the physics reads on the device
_FLOAT_FIELDS = ("body_pos", "body_quat", "body_ipos", "body_iquat",
                 "body_mass", "body_inertia", "jnt_pos", "jnt_axis",
                 "qpos0", "qpos_spring", "dof_armature", "dof_damping",
                 "actuator_gear", "actuator_ctrlrange", "dof_mask",
                 "geom_pos", "geom_quat")


def _upload(model: Model, dev, dtype) -> types.SimpleNamespace:
    arrays = {f: torch.as_tensor(np.asarray(getattr(model, f),
                                            dtype=np.float64),
                                 dtype=dtype, device=dev)
              for f in _FLOAT_FIELDS}
    arrays["actuator_ctrllimited"] = torch.as_tensor(
        np.asarray(model.actuator_ctrllimited, dtype=bool), device=dev)
    # the unit motion axes of a free joint's translations
    arrays["eye6"] = torch.eye(6, dtype=dtype, device=dev)
    # the world body's orientation and the gravity as a spatial
    # acceleration: constants a step would otherwise copy from the host
    # on every call, which no CUDA graph can capture
    arrays["quat_identity"] = torch.tensor([1.0, 0.0, 0.0, 0.0],
                                           dtype=dtype, device=dev)
    arrays["gravity6"] = torch.tensor((0.0, 0.0, 0.0)
                                      + tuple(model.opt.gravity),
                                      dtype=dtype, device=dev)
    # an index on the device: indexing with host lists copies every call
    arrays["geom_bodyid"] = torch.as_tensor(
        np.asarray(model.geom_bodyid, dtype=np.int64), device=dev)
    return types.SimpleNamespace(**arrays)


def device_arrays(model: Model, device, dtype) -> types.SimpleNamespace:
    """The model's float arrays as tensors on ``device``."""
    return on_device(model, device, dtype, _upload)


@dataclasses.dataclass(frozen=True)
class State:
    """The dynamic state: the cpMjData subset
    (reference src/util.cpp:4-14), every field with the same leading
    batch dims."""
    time: torch.Tensor            # (...)
    qpos: torch.Tensor            # (..., nq)
    qvel: torch.Tensor            # (..., nv)
    qacc: torch.Tensor            # (..., nv)
    qacc_warmstart: torch.Tensor  # (..., nv)
    qfrc_applied: torch.Tensor    # (..., nv)
    xfrc_applied: torch.Tensor    # (..., nbody, 6) force, torque at body com
    ctrl: torch.Tensor            # (..., nu)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "State":
        """Apply ``fn`` to every field (indexing, stacking, moving)."""
        return State(**{f.name: fn(getattr(self, f.name))
                        for f in dataclasses.fields(self)})


def make_state(model: Model, batch: int = 1, dtype=torch.float64,
               device=None) -> State:
    """A batch of fresh States at qpos0 (mj_makeData semantics)."""
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype, device=dev)
    qpos0 = torch.as_tensor(model.qpos0, dtype=dtype, device=dev)
    return State(
        time=z(),
        qpos=qpos0.expand(batch, model.nq).clone(),
        qvel=z(model.nv),
        qacc=z(model.nv),
        qacc_warmstart=z(model.nv),
        qfrc_applied=z(model.nv),
        xfrc_applied=z(model.nbody, 6),
        ctrl=z(model.nu),
    )


def stack_states(states, dim: int) -> State:
    """Stack a list of States along ``dim`` of every field."""
    return State(**{f.name: torch.stack([getattr(s, f.name) for s in states],
                                        dim)
                    for f in dataclasses.fields(State)})
