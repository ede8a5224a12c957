"""Smooth (unconstrained) forward dynamics: kinematics, mass matrix, bias
forces, passive forces, actuation.

The port of ``ilqg_mujoco_tpu/physics/smooth.py``: the composite-rigid-body
and RNE recursions are dense masked einsums over (bodies x dofs) with the
model's ancestor masks, and the body/joint loops are static Python loops
over tensors with leading batch dims (instances x knots x perturbations).
All four joint types are ported: a free joint's 6 motion axes are 3
world-frame translations and 3 child-frame rotations, a ball joint's 3
child-frame rotations, and both normalise their quaternion before use.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import linalg
from . import spatial
from .model import (JNT_FREE, JNT_HINGE, JNT_SLIDE, Model, device_arrays,
                    on_device)


class KinOut(NamedTuple):
    """Position-stage quantities (mj_fwdPosition analog)."""
    xpos: torch.Tensor      # (..., nbody,3) body frame origin, world
    xquat: torch.Tensor     # (..., nbody,4)
    xmat: torch.Tensor      # (..., nbody,3,3)
    xipos: torch.Tensor     # (..., nbody,3) body com, world
    ximat: torch.Tensor     # (..., nbody,3,3) inertial frame, world
    xanchor: torch.Tensor   # (..., njnt,3)
    xaxis: torch.Tensor     # (..., njnt,3)
    S: torch.Tensor         # (..., nv,6) dof motion axes, world-origin Plücker
    inertia: torch.Tensor   # (..., nbody,6,6) spatial inertia, world origin
    M: torch.Tensor         # (..., nv,nv) joint-space inertia (with armature)
    geom_xpos: torch.Tensor  # (..., ngeom,3) geom frame origin, world
    geom_xmat: torch.Tensor  # (..., ngeom,3,3) geom frame, world


def _dof_prefix_mask(model: Model) -> np.ndarray:
    """DM[i, j] = 1 iff dof j moves the line that dof i's screw axis is
    rigidly attached to, so that Sdot_i = (sum_j DM[i,j] S_j qvel_j) x S_i
    (see ``ilqg_mujoco_tpu/physics/smooth.py`` for the rules)."""
    nv = model.nv
    dm = np.zeros((nv, nv))
    for i in range(nv):
        bi, ji = int(model.dof_bodyid[i]), int(model.dof_jntid[i])
        if (int(model.jnt_type[ji]) == JNT_FREE
                and i - int(model.jnt_dofadr[ji]) < 3):
            continue  # world-fixed translation axis
        for j in range(nv):
            bj, jj = int(model.dof_bodyid[j]), int(model.dof_jntid[j])
            if bj == bi:
                if jj <= ji:
                    dm[i, j] = 1.0
            elif model.ancestor_mask[bi, bj] and bj != bi:
                dm[i, j] = 1.0
    return dm


def _upload_prefix_mask(model: Model, device, dtype) -> torch.Tensor:
    return torch.as_tensor(_dof_prefix_mask(model), dtype=dtype,
                           device=device)


def dof_prefix_mask(model: Model, device, dtype) -> torch.Tensor:
    return on_device(model, device, dtype, _upload_prefix_mask)


def kinematics(model: Model, qpos: torch.Tensor) -> KinOut:
    """Forward kinematics + dof axes + spatial inertias + mass matrix for a
    batch of configurations ``qpos`` (..., nq)."""
    dt, dev = qpos.dtype, qpos.device
    c = device_arrays(model, dev, dt)
    batch = qpos.shape[:-1]
    full = lambda x: x.expand(batch + x.shape[-1:])
    zero3 = torch.zeros(batch + (3,), dtype=dt, device=dev)

    xpos = [zero3]
    xquat = [full(c.quat_identity)]
    xanchor = [None] * model.njnt
    xaxis = [None] * model.njnt
    S = [None] * model.nv

    for b in range(1, model.nbody):
        p = int(model.body_parentid[b])
        pq = xquat[p]
        pos = xpos[p] + spatial.quat_rotate(pq, c.body_pos[b])
        quat = spatial.quat_mul(pq, c.body_quat[b])
        for j in [j for j in range(model.njnt) if model.jnt_bodyid[j] == b]:
            jt = int(model.jnt_type[j])
            qadr = int(model.jnt_qposadr[j])
            dadr = int(model.jnt_dofadr[j])
            if jt == JNT_FREE:
                pos = qpos[..., qadr:qadr + 3]
                quat = spatial.quat_normalize(qpos[..., qadr + 3:qadr + 7])
                anchor, axis = pos, c.eye6[5, 3:]
                R = spatial.quat_to_mat(quat)
                for k in range(3):
                    S[dadr + k] = c.eye6[3 + k]
                    w = R[..., :, k]
                    S[dadr + 3 + k] = torch.cat([w, spatial.cross(pos, w)], -1)
                xanchor[j], xaxis[j] = full(anchor), full(axis)
                continue
            anchor = pos + spatial.quat_rotate(quat, c.jnt_pos[j])
            axis = spatial.quat_rotate(quat, c.jnt_axis[j])
            if jt == JNT_SLIDE:
                pos = pos + axis * (qpos[..., qadr] - c.qpos0[qadr])[..., None]
                S[dadr] = torch.cat([torch.zeros_like(axis), axis], -1)
            elif jt == JNT_HINGE:
                angle = qpos[..., qadr] - c.qpos0[qadr]
                qloc = spatial.axis_angle_to_quat(c.jnt_axis[j], angle)
                quat = spatial.quat_mul(quat, qloc)
                pos = anchor - spatial.quat_rotate(quat, c.jnt_pos[j])
                S[dadr] = torch.cat([axis, spatial.cross(anchor, axis)], -1)
            else:   # JNT_BALL
                qloc = spatial.quat_normalize(qpos[..., qadr:qadr + 4])
                quat = spatial.quat_mul(quat, qloc)
                pos = anchor - spatial.quat_rotate(quat, c.jnt_pos[j])
                R = spatial.quat_to_mat(quat)
                for k in range(3):
                    w = R[..., :, k]
                    S[dadr + k] = torch.cat([w, spatial.cross(anchor, w)], -1)
            xanchor[j], xaxis[j] = full(anchor), full(axis)
        xpos.append(full(pos))
        xquat.append(full(quat))

    xpos = torch.stack(xpos, -2)
    xquat = torch.stack(xquat, -2)
    xmat = spatial.quat_to_mat(xquat)
    S = torch.stack([full(s) for s in S], -2)
    xanchor = torch.stack(xanchor, -2)
    xaxis = torch.stack(xaxis, -2)

    xipos = xpos + (xmat @ c.body_ipos[..., None]).squeeze(-1)
    ximat = xmat @ spatial.quat_to_mat(c.body_iquat)
    inertia = spatial.spatial_inertia(c.body_mass, c.body_inertia, xipos,
                                      ximat)

    # mass matrix: M = sum_b (mask_b * S)^T I_b (mask_b * S)
    SB = c.dof_mask[:, :, None] * S[..., None, :, :]   # (..., nbody, nv, 6)
    tmp = torch.einsum("...bix,...bxy->...biy", SB, inertia)
    M = torch.einsum("...biy,...bjy->...ij", tmp, SB)
    M = M + torch.diag(c.dof_armature)

    gb = c.geom_bodyid
    geom_xpos = xpos[..., gb, :] + (xmat[..., gb, :, :]
                                    @ c.geom_pos[..., None]).squeeze(-1)
    geom_xmat = xmat[..., gb, :, :] @ spatial.quat_to_mat(c.geom_quat)

    return KinOut(xpos, xquat, xmat, xipos, ximat, xanchor, xaxis, S,
                  inertia, M, geom_xpos, geom_xmat)


def body_velocities(model: Model, kin: KinOut,
                    qvel: torch.Tensor) -> torch.Tensor:
    """Spatial velocity of every body, (..., nbody, 6):
    V_b = sum_i mask[b, i] S_i qvel_i."""
    mask = device_arrays(model, qvel.device, qvel.dtype).dof_mask
    return torch.einsum("bi,...ix,...i->...bx", mask, kin.S, qvel)


def bias_force(model: Model, kin: KinOut, qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_bias = C(q, qvel) + G: RNE with qacc=0 as masked einsums, gravity
    as a fictitious base acceleration (mjData.qfrc_bias semantics)."""
    dt, dev = qvel.dtype, qvel.device
    c = device_arrays(model, dev, dt)
    mask = c.dof_mask                                        # (nbody, nv)
    V = body_velocities(model, kin, qvel)

    # velocity-product acceleration: per-dof prefix velocities
    DM = dof_prefix_mask(model, dev, dt)                     # (nv, nv)
    Sqd = kin.S * qvel[..., None]                            # (..., nv, 6)
    Vpre = DM @ Sqd
    Sdot_qd = spatial.cross_motion(Vpre, kin.S) * qvel[..., None]
    A = torch.einsum("bi,...ix->...bx", mask, Sdot_qd)       # (..., nbody, 6)

    if not model.opt.disable_gravity:
        A = A - c.gravity6

    IV = torch.einsum("...bxy,...by->...bx", kin.inertia, V)
    F = (torch.einsum("...bxy,...by->...bx", kin.inertia, A)
         + spatial.cross_force(V, IV))
    return torch.einsum("bi,...ix,...bx->...i", mask, kin.S, F)


def passive_force(model: Model, qpos: torch.Tensor,
                  qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_passive: joint springs + dampers (mj_passive analog)."""
    c = device_arrays(model, qvel.device, qvel.dtype)
    qfrc = -c.dof_damping * qvel
    springs = {}
    for j in range(model.njnt):
        k = float(model.jnt_stiffness[j])
        if k == 0.0:
            continue
        jt = int(model.jnt_type[j])
        qadr, dadr = int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j])
        if jt in (JNT_SLIDE, JNT_HINGE):
            springs[dadr] = -k * (qpos[..., qadr] - c.qpos_spring[qadr])
            continue
        if jt == JNT_FREE:
            lin = -k * (qpos[..., qadr:qadr + 3]
                        - c.qpos_spring[qadr:qadr + 3])
            for i in range(3):
                springs[dadr + i] = lin[..., i]
            qadr, dadr = qadr + 3, dadr + 3
        rot = -k * spatial.quat_sub(qpos[..., qadr:qadr + 4],
                                    c.qpos_spring[qadr:qadr + 4])
        for i in range(3):
            springs[dadr + i] = rot[..., i]
    if not springs:
        return qfrc
    return torch.stack([qfrc[..., i] + springs[i] if i in springs
                        else qfrc[..., i] for i in range(model.nv)], -1)


def actuator_force(model: Model, ctrl: torch.Tensor) -> torch.Tensor:
    """qfrc_actuator for motor/joint transmissions: gear * clamp(ctrl) on the
    joint's dof."""
    dt, dev = ctrl.dtype, ctrl.device
    batch = ctrl.shape[:-1]
    if model.nu == 0:
        return torch.zeros(batch + (model.nv,), dtype=dt, device=dev)
    c = device_arrays(model, dev, dt)
    if not model.opt.disable_clampctrl:
        lo, hi = c.actuator_ctrlrange[:, 0], c.actuator_ctrlrange[:, 1]
        ctrl = torch.where(c.actuator_ctrllimited,
                           torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)
    force = c.actuator_gear * ctrl
    dofadr = model.jnt_dofadr[model.actuator_trnid]
    zero = torch.zeros(batch, dtype=dt, device=dev)
    cols = []
    for i in range(model.nv):
        col = zero
        for a in np.flatnonzero(dofadr == i):
            col = col + force[..., int(a)]
        cols.append(col)
    return torch.stack(cols, -1)


def applied_force(model: Model, kin: KinOut, qfrc_applied: torch.Tensor,
                  xfrc_applied: torch.Tensor) -> torch.Tensor:
    """qfrc from user-applied generalized + Cartesian forces (xfrc_applied
    rows are (force, torque) at the body com, world coordinates)."""
    c = device_arrays(model, qfrc_applied.device, qfrc_applied.dtype)
    f = xfrc_applied[..., :3]
    t = xfrc_applied[..., 3:]
    w = torch.cat([t + spatial.cross(kin.xipos, f), f], -1)
    return qfrc_applied + torch.einsum("bi,...ix,...bx->...i", c.dof_mask,
                                       kin.S, w)


def smooth_dynamics(model: Model, qpos, qvel, ctrl, qfrc_applied,
                    xfrc_applied):
    """The whole smooth pipeline: returns (kin, qfrc_smooth, qacc_smooth,
    Mfac), with qacc_smooth = M^{-1} qfrc_smooth (mj_fwdAcceleration
    analog) and Mfac the lower Cholesky factor of M."""
    kin = kinematics(model, qpos)
    qfrc_smooth = (passive_force(model, qpos, qvel)
                   + actuator_force(model, ctrl)
                   - bias_force(model, kin, qvel)
                   + applied_force(model, kin, qfrc_applied, xfrc_applied))
    Mfac = linalg.cholesky(kin.M)
    return kin, qfrc_smooth, linalg.cho_solve(Mfac, qfrc_smooth), Mfac


def point_jacobian(model: Model, kin: KinOut, point: torch.Tensor,
                   bodyid) -> torch.Tensor:
    """Translational Jacobian (..., 3, nv) of the world ``point`` (..., 3)
    on body ``bodyid`` (an int, or an index tensor with the batch dims):
    row i is S_lin_i + S_ang_i x point where dof i moves the body."""
    mask = device_arrays(model, point.device, point.dtype).dof_mask[bodyid]
    lin = kin.S[..., 3:] + spatial.cross(kin.S[..., :3], point[..., None, :])
    return (mask[..., None] * lin).transpose(-1, -2)
