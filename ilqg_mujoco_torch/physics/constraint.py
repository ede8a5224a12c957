"""Constraint assembly: joint limits -> unilateral constraint rows
(J, D, aref) for the projected-CG solver.

The port of ``ilqg_mujoco_tpu/physics/constraint.py`` for limit rows:
MuJoCo's soft-constraint model with the impedance imp(r) from solimp at
r = dist - margin, aref = -b*vel - k*(pos - margin) with b = 2/(dmax*tc),
k = imp/(dmax^2 tc^2 dampratio^2) and the clamp tc >= 2*timestep, and the
regularizer R = (1-imp)/imp * dof_invweight0.

Rows exist for every limited slide/hinge joint whatever the state; a row
that is not included (dist >= margin) gets D = 0, so shapes stay static and
J is the same for every instance.  Contact rows come with collision in
slice 3: a model with contact pairs raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import linalg
from .model import JNT_HINGE, JNT_SLIDE, Model, on_device
from .smooth import KinOut

_MINIMP, _MAXIMP = 0.0001, 0.9999


class Efc(NamedTuple):
    J: torch.Tensor      # (nefc, nv), shared by the batch
    D: torch.Tensor      # (..., nefc) inverse regularizer (0: excluded row)
    aref: torch.Tensor   # (..., nefc)
    pos: torch.Tensor    # (..., nefc) raw constraint distance


class EfcPos(NamedTuple):
    """Position-stage constraint quantities (everything except aref's
    velocity term), reused across qvel/ctrl perturbations."""
    J: torch.Tensor      # (nefc, nv)
    D: torch.Tensor      # (..., nefc)
    k: torch.Tensor      # (..., nefc) stiffness
    b: torch.Tensor      # (..., nefc) damping
    r: torch.Tensor      # (..., nefc) dist - margin
    pos: torch.Tensor    # (..., nefc) raw constraint distance

    def aref_of(self, qvel: torch.Tensor) -> torch.Tensor:
        return -self.b * linalg.mv(self.J, qvel) - self.k * self.r


def has_contacts(model: Model) -> bool:
    return (not model.opt.disable_contact) and len(model.pair_geom1) > 0


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


def _row_tensors(model: Model, device, dtype):
    """Per-row constants (J, sign, range end, margin, solref, solimp,
    invweight) on the device."""
    rows = _limit_rows(model)
    J = np.zeros((len(rows), model.nv))
    for i, (_, sgn, _, dadr, _) in enumerate(rows):
        J[i, dadr] = sgn
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    jid = [r[4] for r in rows]
    return dict(
        qadr=[r[0] for r in rows],
        J=t(J),
        sign=t([r[1] for r in rows]),
        end=t([r[2] for r in rows]),
        margin=t(model.jnt_margin[jid]),
        solref=t(np.asarray(model.jnt_solref)[jid].reshape(-1, 2)),
        solimp=t(np.asarray(model.jnt_solimp)[jid].reshape(-1, 5)),
        invw=t(model.dof_invweight0[[r[3] for r in rows]]))


def make_efc_pos(model: Model, kin: KinOut, qpos: torch.Tensor) -> EfcPos:
    """Position-stage constraint assembly: everything that does not depend
    on qvel (J, D, impedance, k, b, violation r)."""
    if has_contacts(model):
        raise NotImplementedError(
            "contact constraints are not ported yet: slice 3")
    rt = on_device(model, qpos.device, qpos.dtype, _row_tensors)
    if not rt["qadr"]:
        z = qpos.new_zeros(qpos.shape[:-1] + (0,))
        return EfcPos(J=qpos.new_zeros((0, model.nv)), D=z, k=z, b=z, r=z,
                      pos=z)
    q = qpos[..., rt["qadr"]]
    dist = rt["sign"] * (q - rt["end"])
    included = dist < rt["margin"]
    r = dist - rt["margin"]
    imp = _impedance(rt["solimp"], r)
    k, b = _kb(rt["solref"], rt["solimp"], imp, model.opt.timestep)
    b = b.expand_as(r)        # depends on the row only; batched like the rest
    R = torch.clamp((1.0 - imp) / imp * rt["invw"], min=1e-12)
    D = torch.where(included, 1.0 / R, torch.zeros_like(R))
    return EfcPos(J=rt["J"], D=D, k=k, b=b, r=r, pos=dist)
