"""Constraint assembly: joint limits + contacts -> unilateral constraint
rows (J, D, aref) for the projected-CG solver.

The port of ``ilqg_mujoco_tpu/physics/constraint.py``: MuJoCo's
soft-constraint model with the impedance imp(r) from solimp at
r = dist - margin, aref = -b*vel - k*(pos - margin) with b = 2/(dmax*tc),
k = imp/(dmax^2 tc^2 dampratio^2) and the clamp tc >= 2*timestep, and the
regularizer R = (1-imp)/imp * invweight, with load-time weights
(dof_invweight0 for limits, the summed translational body_invweight0 of
both bodies for contacts, times 2*mu^2*(1+mu^2) on pyramid rows).

Contacts use the pyramidal friction cone: J = Jn +/- mu*Jt, 2*(condim-1)
rows per condim-3 contact.  Rows come in the JAX package's order: limit
rows, then the condim-1 contacts, then the four pyramid groups
(+t1, -t1, +t2, -t2), each over the condim-3 slots.

Every row exists whatever the state; a row that is not included
(dist >= margin - gap) gets D = 0, so shapes stay static.  With contact
rows J depends on the state and is (..., nefc, nv); a model with limit
rows only keeps one (nefc, nv) J for the whole batch.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from . import linalg
from . import collision
from .model import JNT_HINGE, JNT_SLIDE, Model, on_device
from .smooth import KinOut
from .spatial import cross

_MINIMP, _MAXIMP = 0.0001, 0.9999


class Efc(NamedTuple):
    J: torch.Tensor      # (..., nefc, nv), or (nefc, nv) shared (limits only)
    D: torch.Tensor      # (..., nefc) inverse regularizer (0: excluded row)
    aref: torch.Tensor   # (..., nefc)
    pos: torch.Tensor    # (..., nefc) raw constraint distance


class EfcPos(NamedTuple):
    """Position-stage constraint quantities (everything except aref's
    velocity term), reused across qvel/ctrl perturbations."""
    J: torch.Tensor      # (..., nefc, nv), or (nefc, nv) shared
    D: torch.Tensor      # (..., nefc)
    k: torch.Tensor      # (..., nefc) stiffness
    b: torch.Tensor      # (..., nefc) damping
    r: torch.Tensor      # (..., nefc) dist - margin
    pos: torch.Tensor    # (..., nefc) raw constraint distance

    def aref_of(self, qvel: torch.Tensor) -> torch.Tensor:
        return -self.b * linalg.mv(self.J, qvel) - self.k * self.r


def _impedance(solimp, r):
    """MuJoCo getimpedance(): position-dependent constraint impedance at
    violation r."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    one = torch.ones_like(width)
    x = torch.abs(r) / torch.where(width > 1e-15, width, one)
    x = torch.clamp(x, 0.0, 1.0)
    y_lo = (x / torch.where(mid > 1e-15, mid, one)) ** power * mid
    y_hi = 1.0 - ((1.0 - x) / torch.where(1.0 - mid > 1e-15, 1.0 - mid, one)
                  ) ** power * (1.0 - mid)
    y = torch.where(x <= mid, y_lo, y_hi)
    imp = dmin + y * (dmax - dmin)
    return torch.clamp(imp, _MINIMP, _MAXIMP)


def _kb(solref, solimp, imp, timestep):
    """Stiffness/damping from solref: standard (tc, dampratio) form with the
    tc >= 2*timestep stability clamp, or 'direct' (-stiffness, -damping)."""
    tc, dr = solref[..., 0], solref[..., 1]
    dmax = solimp[..., 1]
    tc_eff = torch.clamp(tc, min=2.0 * timestep)
    b_std = 2.0 / torch.clamp(dmax * tc_eff, min=1e-15)
    k_std = imp / torch.clamp(dmax * dmax * tc_eff * tc_eff * dr * dr,
                              min=1e-15)
    b = torch.where(tc > 0, b_std, -dr)
    k = torch.where(tc > 0, k_std, -tc * imp)
    return k, b


def _limit_rows(model: Model):
    """Static row table of the limit constraints: (joint qpos address,
    sign, range end, dof address, joint id) per row."""
    rows = []
    if model.opt.disable_limit:
        return rows
    for j in range(model.njnt):
        if not model.jnt_limited[j]:
            continue
        if int(model.jnt_type[j]) not in (JNT_SLIDE, JNT_HINGE):
            continue
        qadr, dadr = int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j])
        r0, r1 = model.jnt_range[j]
        # lower: dist = q - r0, J = +e ; upper: dist = r1 - q, J = -e
        rows.append((qadr, 1.0, float(r0), dadr, j))
        rows.append((qadr, -1.0, float(r1), dadr, j))
    return rows


def _row_tensors(model: Model, device, dtype) -> types.SimpleNamespace:
    """Per-row constants on the device: the limit rows' J and (qpos
    address, sign, range end); every row's inclusion threshold, margin,
    solref, solimp and invweight; and the contact rows' slot gathers."""
    lim = _limit_rows(model)
    J = np.zeros((len(lim), model.nv))
    for i, (_, sgn, _, dadr, _) in enumerate(lim):
        J[i, dadr] = sgn
    jid = [r[4] for r in lim]
    margin = [np.asarray(model.jnt_margin)[jid]]
    thresh = [margin[0]]
    solref = [np.asarray(model.jnt_solref)[jid].reshape(-1, 2)]
    solimp = [np.asarray(model.jnt_solimp)[jid].reshape(-1, 5)]
    invw = [model.dof_invweight0[[r[3] for r in lim]]]

    meta = collision.slot_meta(model)
    i1 = np.where(meta.condim == 1)[0]
    i3 = np.where(meta.condim >= 3)[0]
    slots = (np.concatenate([i1] + [i3] * 4)
             if not model.opt.disable_contact else np.zeros(0, int))
    if len(slots):
        mu = meta.friction[:, 0]
        invw_c = (model.body_invweight0[meta.body1, 0]
                  + model.body_invweight0[meta.body2, 0])
        invw_pyr = invw_c * 2.0 * mu * mu * (1.0 + mu * mu)
        margin.append(meta.margin[slots])
        thresh.append((meta.margin - meta.gap)[slots])
        solref.append(meta.solref[slots])
        solimp.append(meta.solimp[slots])
        invw.append(np.concatenate([invw_c[i1]] + [invw_pyr[i3]] * 4))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    cat = lambda xs: t(np.concatenate(xs))
    # indices live on the device: indexing with host lists copies every call
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return types.SimpleNamespace(
        qadr=idx([r[0] for r in lim]), J=t(J), sign=t([r[1] for r in lim]),
        end=t([r[2] for r in lim]), margin=cat(margin), thresh=cat(thresh),
        solref=cat(solref), solimp=cat(solimp), invw=cat(invw),
        nefc=len(lim) + len(slots), contact_slots=idx(slots), i1=idx(i1),
        i3=idx(i3), mu3=t(meta.friction[i3, 0, None]),
        maskdiff=t(model.dof_mask[meta.body2] - model.dof_mask[meta.body1]))


def _contact_J(rt, kin: KinOut, contacts: collision.Contacts):
    """Pyramid-cone rows of every contact, (..., ncon_rows, nv)."""
    # translational Jacobian of each contact point, moved by the dofs of
    # body2 minus those of body1: (..., ncon, nv, 3)
    S = kin.S[..., None, :, :]
    Jp = rt.maskdiff[..., None] * (
        S[..., 3:] + cross(S[..., :3], contacts.pos[..., :, None, :]))
    # projections on the frame rows [n, t1, t2]: (..., ncon, nv, 3)
    Jn, Jt1, Jt2 = (Jp @ contacts.frame.transpose(-1, -2)).unbind(-1)
    n3 = Jn[..., rt.i3, :]
    mt1, mt2 = rt.mu3 * Jt1[..., rt.i3, :], rt.mu3 * Jt2[..., rt.i3, :]
    return torch.cat([Jn[..., rt.i1, :], n3 + mt1, n3 - mt1, n3 + mt2,
                      n3 - mt2], -2)


def make_efc(model: Model, kin: KinOut, qpos: torch.Tensor,
             qvel: torch.Tensor, contacts: collision.Contacts) -> Efc:
    """Assemble every unilateral constraint row (static shape)."""
    pos = make_efc_pos(model, kin, qpos, contacts)
    return Efc(J=pos.J, D=pos.D, aref=pos.aref_of(qvel), pos=pos.pos)


def make_efc_pos(model: Model, kin: KinOut, qpos: torch.Tensor,
                 contacts: collision.Contacts) -> EfcPos:
    """Position-stage constraint assembly: everything that does not depend
    on qvel (J, D, impedance, k, b, violation r)."""
    rt = on_device(model, qpos.device, qpos.dtype, _row_tensors)
    batch = qpos.shape[:-1]
    if rt.nefc == 0:
        z = qpos.new_zeros(batch + (0,))
        return EfcPos(J=qpos.new_zeros((0, model.nv)), D=z, k=z, b=z, r=z,
                      pos=z)
    dist = rt.sign * (qpos[..., rt.qadr] - rt.end)
    J = rt.J
    if len(rt.contact_slots):
        dist = torch.cat([dist, contacts.dist[..., rt.contact_slots]], -1)
        J = torch.cat([J.expand(batch + J.shape),
                       _contact_J(rt, kin, contacts)], -2)
    included = dist < rt.thresh
    r = dist - rt.margin
    imp = _impedance(rt.solimp, r)
    k, b = _kb(rt.solref, rt.solimp, imp, model.opt.timestep)
    b = b.expand_as(r)        # depends on the row only; batched like the rest
    R = torch.clamp((1.0 - imp) / imp * rt.invw, min=1e-12)
    D = torch.where(included, 1.0 / R, torch.zeros_like(R))
    return EfcPos(J=J, D=D, k=k, b=b, r=r, pos=dist)
