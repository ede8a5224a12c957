"""Narrow-phase collision for the geom-type pairs the reference assets use:
the port of ``ilqg_mujoco_tpu/physics/collision.py``.

Broad phase is static: ``Model.pair_geom1/2`` lists every contype /
conaffinity-compatible geom pair at load time (``mjcf.py``), and each pair
contributes a fixed number of contact slots, so the contact tensors have
static shapes.  An inactive slot is masked with a large ``dist`` (and is
then excluded by the constraint rows' ``dist < margin - gap`` test).

The narrow phase runs once per geom-type pair, vectorised over all the
pairs of that type (the humanoid's 161 pairs are 5 such groups); every
slot's tensors carry the leading batch dims of the geom frames.  The
per-slot metadata (bodies, condim, friction, solref, solimp, margin, gap)
is static: :func:`slot_meta` gives it as numpy arrays in slot order.

Contact frame rows are [normal; tangent1; tangent2]; the normal points from
geom1 into geom2 (MuJoCo convention).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .model import (GEOM_BOX, GEOM_CAPSULE, GEOM_PLANE, GEOM_SPHERE, Model,
                    on_device)
from .spatial import cross

_BIG = 1e10   # dist of an inactive slot: finite in float32 too

# static contact slots per (geom1 type, geom2 type)
_NSLOT = {(GEOM_PLANE, GEOM_SPHERE): 1, (GEOM_PLANE, GEOM_CAPSULE): 2,
          (GEOM_PLANE, GEOM_BOX): 8, (GEOM_SPHERE, GEOM_SPHERE): 1,
          (GEOM_SPHERE, GEOM_CAPSULE): 1, (GEOM_CAPSULE, GEOM_CAPSULE): 2}


class Contacts(NamedTuple):
    """Static-shape contact slots (ncon in all)."""
    dist: torch.Tensor   # (..., ncon) negative = penetrating
    pos: torch.Tensor    # (..., ncon, 3) midpoint contact position
    frame: torch.Tensor  # (..., ncon, 3, 3) rows [n, t1, t2]


class SlotMeta(NamedTuple):
    """Per-slot contact parameters, fixed at load time (numpy)."""
    body1: np.ndarray     # (ncon,) int
    body2: np.ndarray     # (ncon,) int
    condim: np.ndarray    # (ncon,) int
    friction: np.ndarray  # (ncon, 3) tangential/rolling (mu1 used)
    solref: np.ndarray    # (ncon, 2)
    solimp: np.ndarray    # (ncon, 5)
    margin: np.ndarray    # (ncon,)
    gap: np.ndarray       # (ncon,)


def _pair_types(model: Model, g1: int, g2: int):
    key = (int(model.geom_type[g1]), int(model.geom_type[g2]))
    if key not in _NSLOT:
        # mjcf.py lists only pair types with a narrow phase; anything else
        # here is a loader bug, so fail rather than skip the pair
        raise NotImplementedError(
            f"no narrow-phase for geom type pair {key}")
    return key


def slot_meta(model: Model) -> SlotMeta:
    """The contact parameters of every slot, in :func:`collide`'s order."""
    rows = []
    for g1, g2 in zip(model.pair_geom1, model.pair_geom2):
        g1, g2 = int(g1), int(g2)
        rows += [_combine(model, g1, g2)] * _NSLOT[_pair_types(model, g1, g2)]
    if not rows:
        return SlotMeta(np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.int32), np.zeros((0, 3)),
                        np.zeros((0, 2)), np.zeros((0, 5)), np.zeros(0),
                        np.zeros(0))
    col = lambda i: [r[i] for r in rows]
    return SlotMeta(
        body1=np.array(col(0), np.int32), body2=np.array(col(1), np.int32),
        condim=np.array(col(2), np.int32), friction=np.array(col(3)),
        solref=np.array(col(4)), solimp=np.array(col(5)),
        margin=np.array(col(6)), gap=np.array(col(7)))


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


def _make_tangents(n, eye):
    """MuJoCo mju_makeFrame tangents: t1 = normalize(n x e_k) with
    k = argmin |n_k| (ties -> lowest index), t2 = n x t1.  The exact
    choice matters: pyramidal friction cones are not rotation-invariant."""
    ax, ay, az = n.abs().unbind(-1)
    use_x = ((ax <= ay) & (ax <= az))[..., None]
    use_y = ((ay <= az)[..., None]) & ~use_x
    e = torch.where(use_x, eye[0], torch.where(use_y, eye[1], eye[2]))
    t1 = cross(n, e)
    t1 = t1 / _norm(t1)[..., None]
    return t1, cross(n, t1)


def _axis_tangents(n, axis, eye):
    """Plane-capsule frame: t1 = -normalize(axis projected into the plane),
    falling back to mju_makeFrame when the capsule is normal to the plane.

    The zero projection is replaced BEFORE the norm: the derivative of ‖x‖
    at x = 0 is NaN, and a ``where`` after the norm would not keep the NaN
    tangent out of the dual (0 * NaN = NaN).  The upright hopper takes this
    branch."""
    proj = axis - n * _dot(n, axis)[..., None]
    ok = ((proj * proj).sum(-1) > 1e-20)[..., None]
    psafe = torch.where(ok, proj, eye[0])
    tm1, tm2 = _make_tangents(n, eye)
    t1 = torch.where(ok, -psafe / _norm(psafe)[..., None], tm1)
    t2 = torch.where(ok, cross(n, t1), tm2)
    return t1, t2


def _plane_sphere(ppos, pmat, c, r):
    n = pmat[..., :, 2]
    dist = _dot(n, c - ppos) - r
    pos = c - n * (r + 0.5 * dist)[..., None]
    return dist, pos, n


def _seg_seg_closest(p1, d1, hl1, p2, d2, hl2):
    """Closest points between the segments p ± hl d (d unit)."""
    r = p1 - p2
    b = _dot(d1, d2)
    f = _dot(d2, r)
    cdot = _dot(d1, r)
    denom = 1.0 - b * b
    nonpar = denom.abs() > 1e-12
    s = torch.where(nonpar, torch.clamp(
        (b * f - cdot) / torch.where(nonpar, denom, 1.0), -hl1, hl1), 0.0)
    t = torch.clamp(b * s + f, -hl2, hl2)
    s = torch.clamp(b * t - cdot, -hl1, hl1)
    return p1 + s[..., None] * d1, p2 + t[..., None] * d2


def _sphere_sphere(c1, r1, c2, r2, eye):
    d = c2 - c1
    ok = (d * d).sum(-1) > 1e-24
    dsafe = torch.where(ok[..., None], d, eye[2])
    nrm = _norm(dsafe)            # guarded before the norm, see above
    n = dsafe / nrm[..., None]
    dist = torch.where(ok, nrm, 0.0) - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, n


def _pair_groups(model: Model, device, dtype) -> SimpleNamespace:
    """The static pairs grouped by geom-type pair, in the order each type
    first appears: per group its geom ids and sizes, and ``order``, the
    position of every slot of :func:`slot_meta`'s order in the groups'
    concatenated output."""
    groups, slot = {}, 0
    for g1, g2 in zip(model.pair_geom1, model.pair_geom2):
        g1, g2 = int(g1), int(g2)
        kind = _pair_types(model, g1, g2)
        g = groups.setdefault(kind, dict(g1=[], g2=[], slots=[]))
        g["g1"].append(g1)
        g["g2"].append(g2)
        g["slots"].append(range(slot, slot + _NSLOT[kind]))
        slot += _NSLOT[kind]
    # group outputs are pair-major within a group; slot i of the model
    # comes from position order[i] of their concatenation
    flat = [i for g in groups.values() for r in g["slots"] for i in r]
    order = np.empty(len(flat), np.int64)
    order[flat] = np.arange(len(flat))
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    size = lambda g: torch.as_tensor(model.geom_size[g], dtype=dtype,
                                     device=device)
    return SimpleNamespace(
        eye=torch.eye(3, dtype=dtype, device=device), order=idx(order),
        groups=[SimpleNamespace(kind=k, g1=idx(g["g1"]), g2=idx(g["g2"]),
                                s1=size(g["g1"]), s2=size(g["g2"]))
                for k, g in groups.items()])


def _narrow_phase(kind, p1, R1, p2, R2, s1, s2, eye):
    """Every slot of a group of pairs of one geom-type pair ``kind``: geom
    frames (..., G, 3) and (..., G, 3, 3), sizes (G, 3).  Returns (dist,
    pos, frame) with a slot dim after the pair dim, (..., G, nslot, ...)."""
    dt = p1.dtype
    slots = []

    def add(dist, pos, n, axis=None):
        t1, t2 = (_make_tangents(n, eye) if axis is None
                  else _axis_tangents(n, axis, eye))
        slots.append((dist, pos, torch.stack([n, t1, t2], -2)))

    if kind == (GEOM_PLANE, GEOM_SPHERE):
        add(*_plane_sphere(p1, R1, p2, s2[:, 0]))
    elif kind == (GEOM_PLANE, GEOM_CAPSULE):
        axis = R2[..., :, 2]
        for sgn in (1.0, -1.0):
            c = p2 + (sgn * s2[:, 1, None]) * axis
            add(*_plane_sphere(p1, R1, c, s2[:, 0]), axis=axis)
    elif kind == (GEOM_PLANE, GEOM_BOX):
        # one slot per box corner, in MuJoCo's corner bit order
        # (mjc_PlaneBox).  MuJoCo keeps at most 4 contacts per pair; a rigid
        # box penetrating a plane short of half its depth has at most 4
        # corners below it, so the masked 8-slot form behaves the same
        n = R1[..., :, 2]
        sign = torch.tensor([[1.0 if i & (1 << a) else -1.0 for a in range(3)]
                             for i in range(8)], dtype=dt, device=s2.device)
        loc = sign * s2[:, None, :]                          # (G, 8, 3)
        corners = p2[..., None, :] + (R2[..., None, :, :]
                                      @ loc[..., None]).squeeze(-1)
        for corner in corners.unbind(-2):
            d = _dot(n, corner - p1)
            add(d, corner - n * (0.5 * d)[..., None], n)
    elif kind == (GEOM_SPHERE, GEOM_SPHERE):
        add(*_sphere_sphere(p1, s1[:, 0], p2, s2[:, 0], eye))
    elif kind == (GEOM_SPHERE, GEOM_CAPSULE):
        axis = R2[..., :, 2]
        hl = s2[:, 1]
        t = torch.clamp(_dot(p1 - p2, axis), -hl, hl)
        add(*_sphere_sphere(p1, s1[:, 0], p2 + t[..., None] * axis,
                            s2[:, 0], eye))
    else:
        # capsule-capsule: two slots.  MuJoCo emits two contacts when the
        # axes are (numerically) parallel, at the ends of the axial
        # overlap, and one closest-point contact otherwise
        # (mjc_CapsuleCapsule); slot 2 is masked unless parallel
        a1, a2 = R1[..., :, 2], R2[..., :, 2]
        r1, hl1, r2, hl2 = s1[:, 0], s1[:, 1], s2[:, 0], s2[:, 1]
        b = _dot(a1, a2)
        # MuJoCo's test is 1 - b^2 < 1e-15 for unit axes, widened per dtype
        # so that rotation round-off of parallel axes passes it
        tol = 1e-12 if dt == torch.float64 else 1e-6
        par = ((1.0 - b * b) < tol)[..., None]
        cg1, cg2 = _seg_seg_closest(p1, a1, hl1, p2, a2, hl2)
        # overlap of segment 2 projected onto segment 1's axis
        proj = _dot(p2 - p1, a1)
        half = b.abs() * hl2
        for slot, sp in enumerate((torch.clamp(proj - half, -hl1, hl1),
                                   torch.clamp(proj + half, -hl1, hl1))):
            cp1 = p1 + sp[..., None] * a1
            cp2 = p2 + torch.clamp(_dot(cp1 - p2, a2), -hl2,
                                   hl2)[..., None] * a2
            d, pos, n = _sphere_sphere(torch.where(par, cp1, cg1), r1,
                                       torch.where(par, cp2, cg2), r2, eye)
            if slot == 1:
                d = torch.where(par[..., 0], d, _BIG)
            add(d, pos, n)
    dist, pos, frame = zip(*slots)
    nd = dist[0].dim()
    return (torch.stack(dist, nd), torch.stack(pos, nd),
            torch.stack(frame, nd))


def collide(model: Model, geom_xpos: torch.Tensor,
            geom_xmat: torch.Tensor) -> Contacts:
    """Evaluate every static candidate pair for a batch of geom frames
    ``geom_xpos`` (..., ngeom, 3), ``geom_xmat`` (..., ngeom, 3, 3).  Each
    geom-type pair is one vectorised evaluation over all its pairs; the
    slots come back in :func:`slot_meta`'s order."""
    batch = geom_xpos.shape[:-2]
    nd = len(batch)
    pg = on_device(model, geom_xpos.device, geom_xpos.dtype, _pair_groups)
    if not pg.groups:
        z = geom_xpos.new_zeros
        return Contacts(z(batch + (0,)), z(batch + (0, 3)),
                        z(batch + (0, 3, 3)))
    outs = []
    for g in pg.groups:
        slots = _narrow_phase(
            g.kind, geom_xpos[..., g.g1, :], geom_xmat[..., g.g1, :, :],
            geom_xpos[..., g.g2, :], geom_xmat[..., g.g2, :, :], g.s1, g.s2,
            pg.eye)
        outs.append([x.flatten(nd, nd + 1) for x in slots])
    return Contacts(*(torch.cat(x, nd).index_select(nd, pg.order)
                      for x in zip(*outs)))


def _combine(model: Model, g1: int, g2: int):
    """MuJoCo's contact-parameter combination: priority wins; otherwise
    condim = max, friction = element-wise max, solref/solimp = the
    solmix-weighted mean (solref = min when either is 'direct'), and
    margins and gaps add."""
    p1, p2 = int(model.geom_priority[g1]), int(model.geom_priority[g2])
    b1, b2 = int(model.geom_bodyid[g1]), int(model.geom_bodyid[g2])
    if p1 != p2:
        g = g1 if p1 > p2 else g2
        condim = int(model.geom_condim[g])
        friction = model.geom_friction[g]
        solref = model.geom_solref[g]
        solimp = model.geom_solimp[g]
    else:
        condim = max(int(model.geom_condim[g1]), int(model.geom_condim[g2]))
        friction = np.maximum(model.geom_friction[g1],
                              model.geom_friction[g2])
        m1, m2 = model.geom_solmix[g1], model.geom_solmix[g2]
        w1 = m1 / (m1 + m2) if (m1 + m2) > 1e-12 else 0.5
        solref = w1 * model.geom_solref[g1] + (1 - w1) * model.geom_solref[g2]
        if model.geom_solref[g1][0] <= 0 or model.geom_solref[g2][0] <= 0:
            solref = np.minimum(model.geom_solref[g1], model.geom_solref[g2])
        solimp = w1 * model.geom_solimp[g1] + (1 - w1) * model.geom_solimp[g2]
    # the option-level override (<flag override="enable"> with
    # o_solref/o_solimp/o_margin) applies only with its flag: the hopper
    # sets o_solref without it, which leaves it inert
    if model.opt.override_active:
        solref = np.array(model.opt.o_solref)
        solimp = np.array(model.opt.o_solimp)
    # includemargin = margin1 + margin2 - gap1 - gap2 (MuJoCo 3.10)
    margin = float(model.geom_margin[g1]) + float(model.geom_margin[g2])
    gap = float(model.geom_gap[g1]) + float(model.geom_gap[g2])
    if model.opt.override_active:
        margin = model.opt.o_margin
    return (b1, b2, condim, friction, solref, solimp, margin, gap)
