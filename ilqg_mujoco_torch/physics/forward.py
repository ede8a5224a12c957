"""Forward dynamics + integrators: the mj_forward / mj_step analogs.

The port of ``ilqg_mujoco_tpu/physics/forward.py``: pure functions of
(Model, State) on batched tensors, split into the stages that
mj_forwardSkip's skip classes name (reference src/mjderivative.cpp:92,
124,178), so the FD linearizer evaluates only the stages a perturbation
class invalidates:

* :func:`pos_stage` — kinematics, mass matrix + factor, collision,
  position-stage constraint rows;
* :func:`vel_stage` — bias/passive forces and the constraint aref;
* :func:`acc_stage` — actuation, applied forces, smooth acceleration and
  the constraint solve.

Integrators: MuJoCo's semi-implicit Euler with implicit joint damping (the
hopper's, dt=0.002) and classic RK4 on the qpos manifold (the cart-pole's,
dt=0.02).

The pipeline above the stages is written once, as generators that yield
each constraint solve's arguments (those of ``solver.solve``) and receive
its ``SolveOut``; ``solver.drive`` runs one with a given solve.  Run with
``solver.solve`` it is the plain eager pipeline: :func:`forward_full`,
and :func:`step` wherever graphs do not engage.  On the card :func:`step`
runs through ``physics/stepgraph``, which cuts the same pipeline into
CUDA graphs at each solve's early-exit loop.  Inside
``profiling.tracing`` each step counts ``step.graphed`` or
``step.eager``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import linalg
from ..utils import profiling
from . import collision, constraint, smooth, solver, spatial, stepgraph
from .model import (INT_RK4, JNT_FREE, JNT_HINGE, JNT_SLIDE, Model, State,
                    device_arrays)


class ForwardAux(NamedTuple):
    kin: smooth.KinOut
    qfrc_smooth: torch.Tensor
    qacc_smooth: torch.Tensor
    qfrc_constraint: torch.Tensor
    efc: constraint.Efc
    contacts: collision.Contacts
    solver_niter: torch.Tensor


class PosStage(NamedTuple):
    """Position-stage products (functions of qpos only)."""
    kin: smooth.KinOut
    Mfac: torch.Tensor
    contacts: collision.Contacts
    efc_pos: constraint.EfcPos


class VelStage(NamedTuple):
    """Velocity-stage products (functions of qpos, qvel)."""
    qfrc_bias: torch.Tensor
    qfrc_passive: torch.Tensor
    aref: torch.Tensor


def pos_stage(model: Model, qpos: torch.Tensor) -> PosStage:
    kin = smooth.kinematics(model, qpos)
    Mfac = linalg.cholesky(kin.M)
    contacts = collision.collide(model, kin.geom_xpos, kin.geom_xmat)
    efc_pos = constraint.make_efc_pos(model, kin, qpos, contacts)
    return PosStage(kin=kin, Mfac=Mfac, contacts=contacts, efc_pos=efc_pos)


def vel_stage(model: Model, pos: PosStage, qpos: torch.Tensor,
              qvel: torch.Tensor) -> VelStage:
    return VelStage(
        qfrc_bias=smooth.bias_force(model, pos.kin, qvel),
        qfrc_passive=smooth.passive_force(model, qpos, qvel),
        aref=pos.efc_pos.aref_of(qvel))


def acc_stage(model: Model, pos: PosStage, vel: VelStage, ctrl: torch.Tensor,
              qfrc_applied: torch.Tensor, xfrc_applied: torch.Tensor,
              qacc_warmstart: torch.Tensor, iterations: int,
              tolerance: float):
    """Actuation + smooth acceleration + constraint solve.  The only stage a
    ctrl perturbation needs to re-run."""
    return solver.drive(_acc_gen(model, pos, vel, ctrl, qfrc_applied,
                                 xfrc_applied, qacc_warmstart, iterations,
                                 tolerance))


def _acc_gen(model, pos, vel, ctrl, qfrc_applied, xfrc_applied,
             qacc_warmstart, iterations, tolerance):
    qfrc_actuator = smooth.actuator_force(model, ctrl)
    qfrc_smooth = (vel.qfrc_passive + qfrc_actuator - vel.qfrc_bias
                   + smooth.applied_force(model, pos.kin, qfrc_applied,
                                          xfrc_applied))
    qacc_smooth = linalg.cho_solve(pos.Mfac, qfrc_smooth)
    efc = constraint.Efc(J=pos.efc_pos.J, D=pos.efc_pos.D, aref=vel.aref,
                         pos=pos.efc_pos.pos)
    out = yield (pos.kin.M, pos.Mfac, qacc_smooth, efc, qacc_warmstart,
                 iterations, tolerance, min(model.opt.ls_iterations, 16))
    return qfrc_smooth, qacc_smooth, efc, out


def forward_full(model: Model, state: State,
                 iterations: Optional[int] = None,
                 tolerance: Optional[float] = None):
    """mj_forward: full pipeline -> (state with qacc/warmstart updated, aux).

    ``iterations``/``tolerance`` override the model options (the FD pinning
    hook)."""
    return solver.drive(_forward_gen(model, state, iterations, tolerance))


def _forward_gen(model, state, iterations, tolerance):
    it = model.opt.iterations if iterations is None else iterations
    tol = model.opt.tolerance if tolerance is None else tolerance

    pos = pos_stage(model, state.qpos)
    vel = vel_stage(model, pos, state.qpos, state.qvel)
    qfrc_smooth, qacc_smooth, efc, out = yield from _acc_gen(
        model, pos, vel, state.ctrl, state.qfrc_applied, state.xfrc_applied,
        state.qacc_warmstart, it, tol)
    new_state = state.replace(qacc=out.qacc, qacc_warmstart=out.qacc)
    aux = ForwardAux(pos.kin, qfrc_smooth, qacc_smooth, out.qfrc_constraint,
                     efc, pos.contacts, out.niter)
    return new_state, aux


def forward(model: Model, state: State, iterations: Optional[int] = None,
            tolerance: Optional[float] = None) -> State:
    return forward_full(model, state, iterations, tolerance)[0]


def integrate_pos(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  h) -> torch.Tensor:
    """mj_integratePos: slide and hinge coordinates move along their dof,
    ball and free-joint quaternions by the quaternion exponential (the map
    the FD linearizer's tangent perturbations use, mju_quatIntegrate)."""
    cols = list(qpos.unbind(-1))
    # h * qvel on the whole vector: under torch.func.hessian a 0-dim slice
    # times a Python float, once stacked, comes back promoted to float64
    step = h * qvel
    for j in range(model.njnt):
        jt = int(model.jnt_type[j])
        qadr, dadr = int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j])
        if jt in (JNT_SLIDE, JNT_HINGE):
            cols[qadr] = cols[qadr] + step[..., dadr]
            continue
        if jt == JNT_FREE:
            for i in range(3):
                cols[qadr + i] = cols[qadr + i] + step[..., dadr + i]
            qadr, dadr = qadr + 3, dadr + 3
        q = spatial.quat_integrate(qpos[..., qadr:qadr + 4],
                                   qvel[..., dadr:dadr + 3], h)
        cols[qadr:qadr + 4] = q.unbind(-1)
    return torch.stack(cols, -1)


def _euler(model: Model, state: State, aux: ForwardAux) -> State:
    """Semi-implicit Euler with implicit joint damping (mj_Euler): qacc
    solves (M + h diag(damping)) qacc = qfrc_smooth + qfrc_constraint."""
    h = model.opt.timestep
    qacc = state.qacc
    if (not model.opt.disable_eulerdamp) and float(
            model.dof_damping.sum()) > 0:
        damping = device_arrays(model, qacc.device, qacc.dtype).dof_damping
        MhB = aux.kin.M + h * torch.diag(damping)
        qacc = linalg.solve_psd(MhB, aux.qfrc_smooth + aux.qfrc_constraint)
    qvel = state.qvel + h * qacc
    qpos = integrate_pos(model, state.qpos, qvel, h)
    return state.replace(time=state.time + h, qpos=qpos, qvel=qvel)


_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6)


def _rk4_gen(model: Model, state: State, iterations, tolerance):
    """Classic RK4 on the qpos manifold (mj_RungeKutta(4)).  Stage 1 reuses
    the already-forwarded qacc; the returned warmstart is the last
    stage's."""
    h = model.opt.timestep
    qpos0, qvel0 = state.qpos, state.qvel
    Fq = [state.qvel]
    Fv = [state.qacc]
    s = state
    for i in range(3):
        dqv = sum(a * f for a, f in zip(_RK4_A[i], Fq) if a != 0)
        dqa = sum(a * f for a, f in zip(_RK4_A[i], Fv) if a != 0)
        qpos_i = integrate_pos(model, qpos0, dqv, h)
        qvel_i = qvel0 + h * dqa
        s = s.replace(qpos=qpos_i, qvel=qvel_i)
        s, _ = yield from _forward_gen(model, s, iterations, tolerance)
        Fq.append(s.qvel)
        Fv.append(s.qacc)
    dqv = sum(b * f for b, f in zip(_RK4_B, Fq))
    dqa = sum(b * f for b, f in zip(_RK4_B, Fv))
    qpos = integrate_pos(model, qpos0, dqv, h)
    qvel = qvel0 + h * dqa
    return state.replace(time=state.time + h, qpos=qpos, qvel=qvel,
                         qacc_warmstart=s.qacc_warmstart)


def step_gen(model: Model, state: State, iterations: Optional[int] = None,
             tolerance: Optional[float] = None):
    """mj_step as a pipeline generator (``solver.drive``): forward + integrate,
    one solve for Euler, four for RK4."""
    st, aux = yield from _forward_gen(model, state, iterations, tolerance)
    if model.opt.integrator == INT_RK4:
        return (yield from _rk4_gen(model, st, iterations, tolerance))
    return _euler(model, st, aux)


def step(model: Model, state: State, iterations: Optional[int] = None,
         tolerance: Optional[float] = None) -> State:
    """mj_step: forward + integrate.  On the card, as CUDA graphs cut at
    the solves wherever ``stepgraph.eligible`` allows; else eagerly."""
    if stepgraph.eligible(state):
        return stepgraph.step(model, state, iterations, tolerance, step_gen)
    profiling.count("step.eager")
    return solver.drive(step_gen(model, state, iterations, tolerance))
