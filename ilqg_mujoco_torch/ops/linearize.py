"""Batched linearization of the dynamics: the port of
``ilqg_mujoco_tpu/ops/linearize.py`` (reference src/mjderivative.cpp).

Three engines, as in the JAX package:

* ``fd`` — reference-exact central differences (below);
* ``ad`` — forward-mode AD of the pinned pipeline: exact qacc Jacobians,
  Euler-assembled like the reference, and exact cost gradients;
* ``exact`` — forward-mode AD of the full discrete step x' = step(x, u):
  exact discrete-time (A, B) for any integrator (the Euler assembly of the
  other two carries an O(h^2) model error under RK4).

The reference's FD engine fans a thread pool out over the derivative
columns; here all 2*(2nv+nu) signed perturbations of every knot of every
instance are one batch dim, so a whole trajectory batch is linearized by
four sequential pinned solves (three warmup repetitions at the center,
then every perturbation at once).  Protocol as in the reference:

* the center runs one full forward, then ``nwarmup-1`` acc-stage-only
  solves chaining ``qacc_warmstart`` (:64-68);
* every perturbed eval starts from the center's warmstart (:91,102,...);
* qpos perturbations re-run every stage, qvel perturbations the vel and acc
  stages, ctrl perturbations only the acc stage (the mj_forwardSkip
  economy, :92,124,178);
* cost gradients are one-sided at the +eps states (:88,120,174).

A, B are Euler-assembled like Differentiator::updateDerivatives
(inc/differentiator.h:85-93), with the reference's transposed-A and
scrambled-B buffer quirks behind flags.

The AD engines fold their 2nv+nu one-hot tangent directions into a batch
dim the way the FD engine folds its perturbations, and push dual tensors
(``torch.autograd.forward_ad``) through one pinned evaluation of every
direction of every knot; the constraint solve contributes its implicit-diff
JVP (``physics/solver.py``), not the CG iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..physics import collision
from ..physics import forward as fwd
from ..physics import smooth, spatial
from ..physics.model import JNT_FREE, JNT_HINGE, JNT_SLIDE, Model, State
from ..utils import profiling

# cost(qpos, qvel, ctrl) -> (...): the stepCostFn_t contract
# (reference inc/mjderivative.h:5) on batched tensors
CostFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LinearizeConfig:
    """Linearizer knobs, FD ones with the reference's exact defaults
    (reference src/mjderivative.cpp:36-39)."""
    eps: float = 1e-6
    niter: int = 30          # pinned solver iterations
    nwarmup: int = 3         # center-point repetitions
    # the reference's column-major read of a row-major FD buffer transposes
    # the qpos/qvel blocks of A (SURVEY.md §7.0.1)
    compat_transpose_A: bool = False
    # the same layout bug on the ctrl Jacobian: identity for nu=1, an index
    # scramble for 1<nu<nv (see scramble_B)
    compat_scramble_B: bool = False
    # 'fd' (reference-exact) | 'ad' (AD of qacc, Euler-assembled like the
    # reference) | 'exact' (AD of the full discrete step: correct for RK4)
    engine: str = "fd"
    # knots linearized at once by linearize_traj: None = every knot in one
    # pass (fastest); c = ceil(T/c) passes of c knots in turn, so the
    # engine's per-lane temporaries (the per-state J of a contact model,
    # its tangents) take c/T of the memory: what lets a card hold a batch
    # whose whole-horizon linearization does not fit
    chunk_knots: int | None = None

    def __post_init__(self):
        if self.engine not in ("fd", "ad", "exact"):
            raise ValueError(f"unknown linearize engine {self.engine!r}")
        if self.chunk_knots is not None and self.chunk_knots < 1:
            raise ValueError(f"chunk_knots must be None or at least 1, not "
                             f"{self.chunk_knots!r}")
        if self.engine == "exact" and (self.compat_transpose_A
                                       or self.compat_scramble_B):
            # the compat flags reproduce the reference's Euler-assembly
            # buffer quirks; linearize_exact has no Euler assembly, so the
            # flags would be a silent no-op
            raise ValueError(
                "compat_transpose_A/compat_scramble_B have no effect with "
                "engine='exact' (no Euler assembly to transpose/scramble); "
                "use engine='fd' or 'ad' for compat-layout linearization")


class LinOut(NamedTuple):
    A: torch.Tensor      # (..., 2nv, 2nv)
    B: torch.Tensor      # (..., 2nv, nu)
    gx: torch.Tensor     # (..., 2nv)   cost gradient wrt [dqpos; qvel]
    gu: torch.Tensor     # (..., nu)
    cost: torch.Tensor   # (...)        center step cost


def _perturb_qpos(model: Model, qpos: torch.Tensor, dof: int, eps):
    """qpos perturbed along tangent direction ``dof``: one coordinate of a
    slide, hinge or free-joint translation; a ball or free-joint rotation
    moves the quaternion by ``quat_integrate`` (the reference's ball/free
    handling, src/mjderivative.cpp:148-171)."""
    j = int(model.dof_jntid[dof])
    jt = int(model.jnt_type[j])
    qadr = int(model.jnt_qposadr[j])
    k = dof - int(model.jnt_dofadr[j])
    cols = list(qpos.unbind(-1))
    if jt == JNT_FREE:
        if k < 3:
            jt = JNT_SLIDE
            qadr += k
        else:
            qadr, k = qadr + 3, k - 3
    if jt in (JNT_SLIDE, JNT_HINGE):
        cols[qadr] = cols[qadr] + eps
        return torch.stack(cols, -1)
    vel = qpos.new_zeros(3)
    vel[k] = eps
    q = spatial.quat_integrate(qpos[..., qadr:qadr + 4], vel, 1.0)
    cols[qadr:qadr + 4] = q.unbind(-1)
    return torch.stack(cols, -1)


def _center(model: Model, state: State, cfg: LinearizeConfig,
            pos: fwd.PosStage = None, vel: fwd.VelStage = None) -> State:
    """Warmed center evaluation: one full forward, then (nwarmup-1)
    acc-stage-only repetitions chaining ``qacc_warmstart`` through the
    pinned solver.  The full forward is the acc stage on the center's own
    pos/vel stages, which callers may pass in to share them."""
    if pos is None:
        pos = fwd.pos_stage(model, state.qpos)
        vel = fwd.vel_stage(model, pos, state.qpos, state.qvel)
    warm = state.qacc_warmstart
    for _ in range(max(cfg.nwarmup, 1)):
        _, _, _, out = fwd.acc_stage(
            model, pos, vel, state.ctrl, state.qfrc_applied,
            state.xfrc_applied, warm, cfg.niter, 0.0)
        warm = out.qacc
    return state.replace(qacc=warm, qacc_warmstart=warm)


def scramble_B(Ju: torch.Tensor) -> torch.Tensor:
    """The reference's 1<nu<nv ctrl-Jacobian layout bug, exactly: the flat
    FD buffer holds flat[i + j*nu] = Ju[j, i] (src/mjderivative.cpp:107)
    and the column-major Map<Matrix<nv,nu>> reads element (a, b) from
    flat[a + b*nv] (inc/differentiator.h:22,59)."""
    nv, nu = Ju.shape[-2:]
    flat = Ju.reshape(Ju.shape[:-2] + (nv * nu,))
    return flat.reshape(Ju.shape[:-2] + (nu, nv)).transpose(-1, -2)


def _assemble(model: Model, Jq, Jv, Ju, cfg: LinearizeConfig):
    """Euler discretization (inc/differentiator.h:68-71, 89-92):
    A = [[I, h I], [h Jq, I + h Jv]],  B = [[0], [h Ju]]."""
    h = model.opt.timestep
    nv, nu = model.nv, model.nu
    if cfg.compat_transpose_A:
        Jq, Jv = Jq.transpose(-1, -2), Jv.transpose(-1, -2)
    if cfg.compat_scramble_B:
        Ju = scramble_B(Ju)
    eye = torch.eye(nv, dtype=Jq.dtype, device=Jq.device).expand_as(Jq)
    A = torch.cat([torch.cat([eye, h * eye], -1),
                   torch.cat([h * Jq, eye + h * Jv], -1)], -2)
    B = torch.cat([torch.zeros(Ju.shape[:-2] + (nv, nu), dtype=Ju.dtype,
                               device=Ju.device), h * Ju], -2)
    return A, B


def _map_stage(fn, *stages):
    """Combine the batched tensors of PosStages (or VelStages) field by
    field with ``fn``.  A J shared by the whole batch (limit rows only)
    passes through."""
    first = stages[0]
    if not isinstance(first, fwd.PosStage):
        return fwd.VelStage(*(fn(*xs) for xs in zip(*stages)))
    efc = first.efc_pos
    shared = efc.J.dim() < efc.D.dim() + 1
    return fwd.PosStage(
        kin=smooth.KinOut(*(fn(*xs) for xs in zip(*(s.kin for s in stages)))),
        Mfac=fn(*(s.Mfac for s in stages)),
        contacts=collision.Contacts(*(fn(*xs) for xs in
                                      zip(*(s.contacts for s in stages)))),
        efc_pos=efc._replace(**{
            f: fn(*(getattr(s.efc_pos, f) for s in stages))
            for f in efc._fields if not (f == "J" and shared)}))


def linearize_fd(model: Model, state: State, cost_fn: CostFn,
                 cfg: LinearizeConfig = LinearizeConfig()) -> LinOut:
    """Reference-exact FD linearization of every state in a batch (any
    leading dims: instances x knots)."""
    nv, nu = model.nv, model.nu
    dt, dev = state.qpos.dtype, state.qpos.device
    eps = cfg.eps
    batch = state.qpos.shape[:-1]
    nb = len(batch)
    npert = 4 * nv + 2 * nu

    def rep(x, n):
        """Repeat a batched tensor over a perturbation dim of size n."""
        return x.unsqueeze(nb).expand(x.shape[:nb] + (n,) + x.shape[nb:])

    pos_c = fwd.pos_stage(model, state.qpos)
    vel_c = fwd.vel_stage(model, pos_c, state.qpos, state.qvel)
    warm = _center(model, state, cfg, pos_c, vel_c).qacc_warmstart
    cost0 = cost_fn(state.qpos, state.qvel, state.ctrl)

    # perturbations along a new dim after the batch dims:
    # [qpos+ (nv), qpos- (nv)], [qvel+, qvel-], [ctrl+ (nu), ctrl- (nu)]
    qpos_pert = torch.stack(
        [_perturb_qpos(model, state.qpos, i, eps) for i in range(nv)]
        + [_perturb_qpos(model, state.qpos, i, -eps) for i in range(nv)],
        nb)                                              # (..., 2nv, nq)
    eyev = torch.eye(nv, dtype=dt, device=dev)
    qvel_pert = torch.cat([rep(state.qvel, 1) + eps * eyev,
                           rep(state.qvel, 1) - eps * eyev], nb)
    eyeu = torch.eye(nu, dtype=dt, device=dev)
    ctrl_pert = torch.cat([rep(state.ctrl, 1) + eps * eyeu,
                           rep(state.ctrl, 1) - eps * eyeu], nb)

    # stage products of each class, then ONE acc-stage solve over all
    # perturbations, each from the center's warmstart
    pos_q = fwd.pos_stage(model, qpos_pert)
    vel_q = fwd.vel_stage(model, pos_q, qpos_pert, rep(state.qvel, 2 * nv))
    pos_v = _map_stage(lambda x: rep(x, 2 * nv), pos_c)
    vel_v = fwd.vel_stage(model, pos_v, rep(state.qpos, 2 * nv), qvel_pert)
    pos_u = _map_stage(lambda x: rep(x, 2 * nu), pos_c)
    vel_u = _map_stage(lambda x: rep(x, 2 * nu), vel_c)
    cat = lambda *xs: torch.cat(xs, nb)
    _, _, _, out = fwd.acc_stage(
        model, _map_stage(cat, pos_q, pos_v, pos_u),
        _map_stage(cat, vel_q, vel_v, vel_u),
        cat(rep(state.ctrl, 4 * nv), ctrl_pert),
        rep(state.qfrc_applied, npert), rep(state.xfrc_applied, npert),
        rep(warm, npert), cfg.niter, 0.0)
    qacc = out.qacc.transpose(-1, -2)                    # (..., nv, npert)

    inv2eps = 1.0 / (2.0 * eps)
    Jq = (qacc[..., :nv] - qacc[..., nv:2 * nv]) * inv2eps
    Jv = (qacc[..., 2 * nv:3 * nv] - qacc[..., 3 * nv:4 * nv]) * inv2eps
    Ju = (qacc[..., 4 * nv:4 * nv + nu] - qacc[..., 4 * nv + nu:]) * inv2eps

    # one-sided cost gradients at the +eps states
    cost_qpos = cost_fn(qpos_pert[..., :nv, :], rep(state.qvel, nv),
                        rep(state.ctrl, nv))
    cost_qvel = cost_fn(rep(state.qpos, nv), qvel_pert[..., :nv, :],
                        rep(state.ctrl, nv))
    cost_ctrl = cost_fn(rep(state.qpos, nu), rep(state.qvel, nu),
                        ctrl_pert[..., :nu, :])
    c0 = cost0[..., None]
    gx = torch.cat([cost_qpos - c0, cost_qvel - c0], -1) / eps
    gu = (cost_ctrl - c0) / eps

    A, B = _assemble(model, Jq, Jv, Ju, cfg)
    return LinOut(A=A, B=B, gx=gx, gu=gu, cost=cost0)


def _directions(model: Model, state: State, warm: torch.Tensor):
    """The states of a batch repeated over the P = 2nv+nu one-hot tangent
    directions (a new dim after the batch dims), as dual tensors:
    direction p < nv moves qpos along dof p (through ``integrate_pos``),
    nv <= p < 2nv moves qvel, p >= 2nv moves ctrl.  Every copy starts the
    solver from ``warm``.  Call inside ``fwAD.dual_level()``."""
    nv, nu = model.nv, model.nu
    P = 2 * nv + nu
    batch = state.qpos.shape[:-1]
    nb = len(batch)

    def rep(x):
        return x.unsqueeze(nb).expand(x.shape[:nb] + (P,) + x.shape[nb:])

    eye = torch.eye(P, dtype=state.qpos.dtype, device=state.qpos.device)

    def dual(cols):
        tangent = eye[:, cols].expand(batch + (P, cols.stop - cols.start))
        return fwAD.make_dual(torch.zeros_like(tangent),
                              tangent.contiguous())

    qpos = fwd.integrate_pos(model, rep(state.qpos), dual(slice(0, nv)), 1.0)
    return State(time=rep(state.time), qpos=qpos,
                 qvel=rep(state.qvel) + dual(slice(nv, 2 * nv)),
                 qacc=rep(state.qacc), qacc_warmstart=rep(warm),
                 qfrc_applied=rep(state.qfrc_applied),
                 xfrc_applied=rep(state.xfrc_applied),
                 ctrl=rep(state.ctrl) + dual(slice(2 * nv, P)))


def linearize_ad(model: Model, state: State, cost_fn: CostFn,
                 cfg: LinearizeConfig = LinearizeConfig()) -> LinOut:
    """Forward-mode AD linearization of every state in a batch: exact
    Jacobians of the pinned pipeline, exact cost gradients.  Same output
    contract as :func:`linearize_fd`."""
    nv = model.nv
    warm = _center(model, state, cfg).qacc_warmstart
    with fwAD.dual_level():
        s = _directions(model, state, warm)
        qacc = fwd.forward(model, s, iterations=cfg.niter,
                           tolerance=0.0).qacc
        J = fwAD.unpack_dual(qacc).tangent.transpose(-1, -2)  # (..., nv, P)
        g = fwAD.unpack_dual(cost_fn(s.qpos, s.qvel, s.ctrl)).tangent
    cost0 = cost_fn(state.qpos, state.qvel, state.ctrl)
    A, B = _assemble(model, J[..., :nv], J[..., nv:2 * nv],
                     J[..., 2 * nv:], cfg)
    return LinOut(A=A, B=B, gx=g[..., :2 * nv], gu=g[..., 2 * nv:],
                  cost=cost0)


def _qpos_diff(model: Model, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tangent-space configuration difference a ominus b in R^{nv}: plain
    subtraction of slide, hinge and free-joint translation coordinates, the
    quaternion log map (``quat_sub``) for ball and free-joint rotations."""
    if model.nq == model.nv:
        return a - b
    parts = []
    for j in range(model.njnt):
        jt = int(model.jnt_type[j])
        qadr = int(model.jnt_qposadr[j])
        if jt in (JNT_SLIDE, JNT_HINGE):
            parts.append(a[..., qadr:qadr + 1] - b[..., qadr:qadr + 1])
            continue
        if jt == JNT_FREE:
            parts.append(a[..., qadr:qadr + 3] - b[..., qadr:qadr + 3])
            qadr += 3
        parts.append(spatial.quat_sub(a[..., qadr:qadr + 4],
                                      b[..., qadr:qadr + 4]))
    return torch.cat(parts, -1)


def linearize_exact(model: Model, state: State, cost_fn: CostFn,
                    cfg: LinearizeConfig = LinearizeConfig()) -> LinOut:
    """Exact discrete-time linearization of every state in a batch:
    A = dx'/dx, B = dx'/du of the full step map (integrator included) by
    forward-mode AD, in tangent-space coordinates at the center's next
    state."""
    nv = model.nv
    warm = _center(model, state, cfg).qacc_warmstart
    with fwAD.dual_level():
        s = _directions(model, state, warm)
        s2 = fwd.step(model, s, iterations=cfg.niter, tolerance=0.0)
        # x' ominus x'_0 about the center's next state x'_0 (the primal):
        # zero, with the Jacobian columns as its tangent
        nxt = torch.cat([
            _qpos_diff(model, s2.qpos, fwAD.unpack_dual(s2.qpos).primal),
            s2.qvel], -1)
        J = fwAD.unpack_dual(nxt).tangent.transpose(-1, -2)  # (..., 2nv, P)
        g = fwAD.unpack_dual(cost_fn(s.qpos, s.qvel, s.ctrl)).tangent
    cost0 = cost_fn(state.qpos, state.qvel, state.ctrl)
    return LinOut(A=J[..., :2 * nv].contiguous(),
                  B=J[..., 2 * nv:].contiguous(), gx=g[..., :2 * nv],
                  gu=g[..., 2 * nv:], cost=cost0)


_ENGINES = {"fd": linearize_fd, "ad": linearize_ad, "exact": linearize_exact}


def linearize_traj(model: Model, states: State, cost_fn: CostFn,
                   cfg: LinearizeConfig = LinearizeConfig()) -> LinOut:
    """Linearize every knot of a (B, T) trajectory batch in one batched
    pass: this single call replaces the reference's N+1 serialized
    calcMJDerivatives invocations inside the backward loop
    (inc/ilqr.h:153-154).

    With ``cfg.chunk_knots = c`` the knots go through the engine c at a
    time, one chunk after the other, so that a chunk's temporaries are
    freed before the next chunk starts.  The knot dim is padded to whole
    chunks by repeating the last knot, so that every chunk has one shape
    (and the CG captures one graph for each of its solves, not two); the
    outputs are concatenated and the padding dropped."""
    with profiling.span("linearize", device=True):
        return _chunked(model, states, cost_fn, cfg)


def _chunked(model: Model, states: State, cost_fn: CostFn,
             cfg: LinearizeConfig) -> LinOut:
    """:func:`linearize_traj`'s work, chunk by chunk where asked."""
    engine = _ENGINES[cfg.engine]
    c = cfg.chunk_knots
    if c is None:
        return engine(model, states, cost_fn, cfg)
    d = states.qpos.dim() - 2            # the knot dim: the last batch dim
    T = states.qpos.shape[d]
    pad = -T % c

    def padded(a):
        tail = list(a.shape)
        tail[d] = pad
        return torch.cat([a, a.narrow(d, T - 1, 1).expand(tail)], d)

    if pad:
        states = states.map(padded)
    outs = []
    for start in range(0, T, c):
        out = engine(model, states.map(lambda a: a.narrow(d, start, c)),
                     cost_fn, cfg)
        keep = min(c, T - start)         # the last chunk's knots of T
        outs.append(out if keep == c else
                    LinOut(*(x.narrow(d, 0, keep) for x in out)))
    return LinOut(*(torch.cat(xs, d) for xs in zip(*outs)))
