"""The plain iLQR reference: the compat recursion and the tassa iLQG
iteration (sequential backward pass, value scaling, parallel linesearch).

A frozen copy of the program's ``ilqr.py`` as it stood when the benchmark
was written, cut to what the benchmark's configurations run: no
control limits, no associative-scan backward pass, and the compat backward
pass as the general reverse loop (:func:`backward_pass_compat`), never the
CUDA kernel.  It imports nothing of the program.  Reference line numbers
(``inc/ilqr.h``) are the original C++ iLQG-MuJoCo's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch import func

from . import linalg
from .linearize import (CostFn, LinearizeConfig, LinOut, _qpos_diff,
                        linearize_traj)
from . import forward as fwd
from .model import Model, State, stack_states


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 20
    iterations: int = 10
    mode: str = "compat"              # 'compat' | 'tassa'
    mu: float = 1000.0                # fixed LM shift (inc/ilqr.h:65)
    lin: LinearizeConfig = LinearizeConfig()
    mu_min: float = 1e-6
    mu_max: float = 1e10
    mu_factor: float = 1.6
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.05, 0.01)
    reg_init: float = 1e-6            # initial ILQRState.mu
    value_scaling: bool = False


def first_argmin(v: torch.Tensor) -> torch.Tensor:
    """Index of the minimum over the last dim: the first NaN if there is
    one, else the first of tied minima."""
    m = v.amin(-1, keepdim=True)          # NaN if any entry is NaN
    hit = (v == m) | (torch.isnan(v) & torch.isnan(m))
    idx = torch.arange(v.shape[-1], device=v.device).expand_as(v)
    return torch.where(hit, idx, v.shape[-1]).amin(-1)


def iterate_compat(model: Model, cost_fn: CostFn, x0: State,
                   sol: "ILQRState", cfg: ILQRConfig):
    """One reference iteration (inc/ilqr.h:179-186): forward, linearize,
    backward.  Returns (solver state, (B,) trajectory cost)."""
    traj = forward_pass(model, x0, sol, cfg)
    lin = linearize_traj(model, traj, cost_fn, cfg.lin)
    K, k = backward_pass_compat(model, traj, lin, cfg)
    cost = _traj_cost(cost_fn, traj)
    return ILQRState(traj=traj, K=K, k=k, mu=sol.mu), cost


class ILQRState(NamedTuple):
    """Persistent solver state (the ILQR object's data, inc/ilqr.h:44-65)."""
    traj: State            # (B, N+1, ...) knots, knot t carries its ctrl u_t
    K: torch.Tensor        # (B, N+1, nu, 2nv)
    k: torch.Tensor        # (B, N+1, nu)
    mu: torch.Tensor       # (B,) LM parameter (tassa mode)


def state_diff(model: Model, s_qpos, s_qvel, r_qpos, r_qvel) -> torch.Tensor:
    """Tangent-space state difference x - x* in R^{2nv}: the reference's
    contiguous [qpos; qvel] subtraction (inc/ilqr.h:90,126) where nq = nv,
    with the quaternion log map for ball and free-joint rotations."""
    return torch.cat([_qpos_diff(model, s_qpos, r_qpos), s_qvel - r_qvel], -1)


def init_solver(model: Model, x0: State, cfg: ILQRConfig) -> ILQRState:
    """Initial trajectory: roll the initial states forward under their
    current ctrl (the ILQR ctor loop, inc/ilqr.h:82-87), K/k = 0."""
    knots, s = [], x0
    for t in range(cfg.horizon + 1):
        knots.append(s)
        if t < cfg.horizon:
            s = fwd.step(model, s)
    B, dt, dev = x0.qpos.shape[0], x0.qpos.dtype, x0.qpos.device
    n1 = cfg.horizon + 1
    return ILQRState(
        traj=stack_states(knots, 1),
        K=torch.zeros((B, n1, model.nu, 2 * model.nv), dtype=dt, device=dev),
        k=torch.zeros((B, n1, model.nu), dtype=dt, device=dev),
        mu=torch.full((B,), cfg.reg_init, dtype=dt, device=dev))


def forward_pass(model: Model, x0: State, sol: ILQRState,
                 cfg: ILQRConfig, alpha=1.0) -> State:
    """Roll out u = K (x - x*) + alpha*k + u* from x0 through the full
    nonlinear dynamics (inc/ilqr.h:116-130).  ``alpha`` is a scalar or a
    (B,) tensor, one step size per instance.  Each knot is stored before
    it is stepped; the step after the terminal knot is never used and not
    taken."""
    ref = sol.traj
    if torch.is_tensor(alpha) and alpha.dim() == 1:
        alpha = alpha[:, None]
    knots, s = [], x0
    for t in range(cfg.horizon + 1):
        dx = state_diff(model, s.qpos, s.qvel, ref.qpos[:, t], ref.qvel[:, t])
        u = linalg.mv(sol.K[:, t], dx) + alpha * sol.k[:, t] + ref.ctrl[:, t]
        knot = s.replace(ctrl=u)
        knots.append(knot)
        if t < cfg.horizon:
            s = fwd.step(model, knot)
    return stack_states(knots, 1)


def _traj_cost(cost_fn: CostFn, traj: State) -> torch.Tensor:
    return cost_fn(traj.qpos, traj.qvel, traj.ctrl).sum(-1)


def _T(X: torch.Tensor) -> torch.Tensor:
    return X.transpose(-1, -2)


def knot_gaps(model: Model, traj: State) -> torch.Tensor:
    """c_t = x*_{t+1} - x*_t (inc/ilqr.h:161-163), (B, N, 2nv)."""
    return state_diff(model, traj.qpos[:, 1:], traj.qvel[:, 1:],
                      traj.qpos[:, :-1], traj.qvel[:, :-1])


def backward_pass_compat(model: Model, traj: State, lin: LinOut,
                         cfg: ILQRConfig):
    """inc/ilqr.h:133-176 for any nu, as a reverse loop over batched tensors.
    All quirks intentional.  Returns K (B, N+1, nu, 2nv), k (B, N+1, nu)
    with zero terminal gains."""
    N = cfg.horizon
    nv2, nu = 2 * model.nv, model.nu
    dt, dev = lin.A.dtype, lin.A.device
    Bsz = lin.A.shape[0]
    eye = torch.eye(nv2, dtype=dt, device=dev)
    outer = lambda a, b: a[..., :, None] * b[..., None, :]
    vm = lambda x, M: (x[..., None, :] @ M).squeeze(-2)   # row vector @ M

    # initV (inc/ilqr.h:100-107): terminal knot gradient outer product
    v = lin.gx[:, N]
    V = outer(v, v)
    diffs = knot_gaps(model, traj)
    Ks, ks = [None] * N, [None] * N
    for t in reversed(range(N)):
        A, B, q, r, c = (lin.A[:, t], lin.B[:, t], lin.gx[:, t],
                         lin.gu[:, t], diffs[:, t])
        V = 0.5 * (V + _T(V))
        Q = outer(q, q)
        R = outer(r, r)
        V = V + cfg.mu * eye                     # shift never removed (:168)
        # reference: (-2 B^T V B - 2R).ldlt() (inc/ilqr.h:167); -T is SPD
        # under the LM shift, so solve the negated system with Cholesky
        negT = 2.0 * _T(B) @ V @ B + 2.0 * R
        Lt = linalg.cholesky(negT)
        K = -linalg.cho_solve(Lt, 2.0 * _T(B) @ V @ A)
        k = -linalg.cho_solve(Lt, linalg.mv(_T(B), v + 2.0 * linalg.mv(V, c))
                              + r)
        ABK = A + B @ K
        V_new = _T(ABK) @ V @ ABK + Q + _T(K) @ R @ K
        # the reference assigns *V first and the *v update then reads the
        # NEW V (inc/ilqr.h:173-174): replicated deliberately
        v = (2.0 * vm(vm(linalg.mv(B, k) + c, V_new), ABK) + vm(v, ABK) + q
             + 2.0 * vm(vm(k, R), K))
        V = V_new
        Ks[t], ks[t] = K, k
    Ks.append(torch.zeros((Bsz, nu, nv2), dtype=dt, device=dev))
    ks.append(torch.zeros((Bsz, nu), dtype=dt, device=dev))
    return torch.stack(Ks, 1), torch.stack(ks, 1)


def _cost_quadratics(cost_fn: CostFn, model: Model, traj: State):
    """Exact cost expansion per knot by autodiff through ``integrate_pos``
    (replaces the reference's rank-1 approximations): lx (..., 2nv),
    lu (..., nu), lxx (..., 2nv, 2nv), luu (..., nu, nu), lux (..., nu, 2nv)
    for every knot of a (B, T) trajectory batch."""
    nv, nu = model.nv, model.nu

    def f(dx, du, qpos, qvel, ctrl):
        qp = fwd.integrate_pos(model, qpos, dx[:nv], 1.0)
        return cost_fn(qp, qvel + dx[nv:], ctrl + du)

    def at_knot(qpos, qvel, ctrl):
        a = (qpos.new_zeros(2 * nv), qpos.new_zeros(nu), qpos, qvel, ctrl)
        return (func.grad(f, 0)(*a), func.grad(f, 1)(*a),
                func.hessian(f, 0)(*a), func.hessian(f, 1)(*a),
                func.jacfwd(func.grad(f, 1), 0)(*a))

    batch = traj.qpos.shape[:-1]
    flat = lambda x: x.reshape((-1,) + x.shape[len(batch):])
    out = func.vmap(at_knot)(flat(traj.qpos), flat(traj.qvel),
                             flat(traj.ctrl))
    return tuple(o.reshape(batch + o.shape[1:]) for o in out)


def _tassa_recursion(model: Model, lin: LinOut, quad, ctrl: torch.Tensor,
                     mu: torch.Tensor, cfg: ILQRConfig):
    """The iLQG backward recursion with LM-regularized Quu, as a reverse
    loop over batched tensors, given the cost quadratics ``quad``.  Returns
    (K, k, dV1, dV2, ok) with per-instance (B,) dV1, dV2 and ok."""
    N = cfg.horizon
    nv2, nu = 2 * model.nv, model.nu
    dt, dev = lin.A.dtype, lin.A.device
    Bsz = lin.A.shape[0]
    lx, lu, lxx, luu, lux = quad
    eye = torch.eye(nu, dtype=dt, device=dev)
    zero = torch.zeros((Bsz,), dtype=dt, device=dev)
    if cfg.value_scaling:
        eps = torch.finfo(dt).eps
        big = torch.finfo(dt).max / 16

        def sat(a):
            return torch.clamp(torch.nan_to_num(
                a, nan=0.0, posinf=big, neginf=-big), -big, big)

    # Vx/Vxx are the value function divided by s = exp(log_s); log_s is
    # identically 0 unless cfg.value_scaling.  Gains are ratios, so
    # computing them from (l*/s + transport of V/s) with mu/s is exact.
    Vx, Vxx = lx[:, N], lxx[:, N]
    log_s, dV1, dV2 = zero, zero, zero
    ok = torch.ones((Bsz,), dtype=torch.bool, device=dev)
    Ks, ks = [None] * N, [None] * N
    for t in reversed(range(N)):
        A, B = lin.A[:, t], lin.B[:, t]
        inv_s = torch.exp(-log_s)
        s1, s2 = inv_s[:, None], inv_s[:, None, None]
        Qx = lx[:, t] * s1 + linalg.mv(_T(A), Vx)
        Qu = lu[:, t] * s1 + linalg.mv(_T(B), Vx)
        Qxx = lxx[:, t] * s2 + _T(A) @ Vxx @ A
        Quu = luu[:, t] * s2 + _T(B) @ Vxx @ B
        Qux = lux[:, t] * s2 + _T(B) @ Vxx @ A
        mu_eff = mu * inv_s
        if cfg.value_scaling:
            # once s dwarfs mu the true LM shift underflows in normalized
            # space; an eps floor RELATIVE to ||Quu|| keeps Quu_reg
            # factorizable without perturbing any representable ratio
            mu_eff = mu_eff + 10.0 * eps * torch.clamp(
                Quu.abs().amax((-1, -2)), min=1.0)
        Quu_reg = Quu + mu_eff[:, None, None] * eye
        L = linalg.cholesky(Quu_reg)
        pd = torch.isfinite(L).all(-1).all(-1)
        Ls = torch.where(pd[:, None, None], L, eye)
        K = -linalg.cho_solve(Ls, Qux)
        k = -linalg.cho_solve(Ls, Qu)
        Vx_n = (Qx + linalg.mv(_T(K) @ Quu, k) + linalg.mv(_T(K), Qu)
                + linalg.mv(_T(Qux), k))
        Vxx_n = Qxx + _T(K) @ Quu @ K + _T(K) @ Qux + _T(Qux) @ K
        Vxx_n = 0.5 * (Vxx_n + _T(Vxx_n))
        # dV in true units (s * normalized step terms)
        s_true = torch.exp(log_s)
        dV1 = dV1 + linalg.dot(k, Qu) * s_true
        dV2 = dV2 + 0.5 * linalg.dot(k, linalg.mv(Quu, k)) * s_true
        if cfg.value_scaling:
            # saturate BEFORE rescaling: a transport that overflowed to inf
            # within one step would give inf/inf = NaN and poison every
            # earlier knot's gains; saturated entries distort only steps
            # the linesearch rejects anyway
            Vx_n, Vxx_n = sat(Vx_n), sat(Vxx_n)
            c = torch.clamp(Vxx_n.abs().amax((-1, -2)), min=1.0)
            Vx_n = Vx_n / c[:, None]
            Vxx_n = Vxx_n / c[:, None, None]
            log_s = log_s + torch.log(c)
        Vx, Vxx, ok = Vx_n, Vxx_n, ok & pd
        Ks[t], ks[t] = K, k
    Ks.append(torch.zeros((Bsz, nu, nv2), dtype=dt, device=dev))
    ks.append(torch.zeros((Bsz, nu), dtype=dt, device=dev))
    return torch.stack(Ks, 1), torch.stack(ks, 1), dV1, dV2, ok


def backward_pass_tassa(model: Model, traj: State, lin: LinOut,
                        cost_fn: CostFn, mu: torch.Tensor, cfg: ILQRConfig):
    """Standard iLQG backward recursion with LM-regularized Quu for a batch
    with per-instance ``mu`` (B,).

    Returns (K, k, dV1, dV2, ok): gains (B, N+1, ...) with zero terminal
    gains, expected-improvement terms and a positive-definiteness flag per
    instance for the mu adaptation."""
    return _tassa_recursion(model, lin, _cost_quadratics(cost_fn, model,
                                                         traj),
                            traj.ctrl, mu, cfg)


def linesearch_rollouts(model: Model, cost_fn: CostFn, x0: State,
                        sol: ILQRState, K: torch.Tensor, k: torch.Tensor,
                        cfg: ILQRConfig):
    """Roll out the gains (K, k) about the stored trajectory from x0 for
    every alpha in (0,) + cfg.alphas at once: the alphas are folded into
    the batch dim, so one ``forward_pass`` runs (len(alphas)+1) * B
    instances.  Returns (trajectories (na, B, N+1, ...), costs (na, B))."""
    na, Bsz = len(cfg.alphas) + 1, x0.qpos.shape[0]
    alphas = torch.tensor((0.0,) + tuple(cfg.alphas), dtype=k.dtype,
                          device=k.device).repeat_interleave(Bsz)
    rep = lambda x: x.repeat((na,) + (1,) * (x.dim() - 1))   # alpha-major
    cand = ILQRState(traj=sol.traj.map(rep), K=rep(K), k=rep(k),
                     mu=rep(sol.mu))
    trajs = forward_pass(model, x0.map(rep), cand, cfg, alpha=alphas)
    costs = _traj_cost(cost_fn, trajs).reshape(na, Bsz)
    return trajs.map(lambda x: x.reshape((na, Bsz) + x.shape[1:])), costs


def linesearch_select(cost_fn: CostFn, sol: ILQRState, K: torch.Tensor,
                      k: torch.Tensor, ok: torch.Tensor, trajs: State,
                      costs: torch.Tensor, cfg: ILQRConfig):
    """Accept the best alpha per instance and adapt mu.

    The acceptance baseline is the alpha=0 (feedback-only) rollout from
    the current x0, not the cost of the stored trajectory: under MPC the
    stored trajectory starts at the previous frame's state, and comparing
    against its stale cost rejects every step once the state has drifted
    somewhere worse.  When that rollout is not finite the stale cost is the
    baseline and the stored trajectory is kept.  When x0 == traj[0] the
    alpha=0 rollout reproduces the stored trajectory exactly.

    Returns (solver state, (B,) cost, (B,) selection): the index into
    (0,) + cfg.alphas of the accepted rollout, 0 for the rebase onto the
    alpha=0 rollout, -1 for keeping the stored trajectory."""
    Bsz = costs.shape[1]
    cost_stale = _traj_cost(cost_fn, sol.traj)
    rebase_ok = torch.isfinite(costs[0])
    cost0 = torch.where(rebase_ok, costs[0], cost_stale)
    best = first_argmin(_T(costs[1:])) + 1
    lane = torch.arange(Bsz, device=costs.device)
    cbest = costs[best, lane]
    improved = ok & (cbest < cost0)
    sel = torch.where(improved, best,
                      torch.where(rebase_ok, 0, -1))
    take = sel.clamp(min=0)

    def pick(cands, old):
        keep = (sel >= 0).reshape((Bsz,) + (1,) * (old.dim() - 1))
        return torch.where(keep, cands[take, lane], old)

    new_traj = State(**{f.name: pick(getattr(trajs, f.name),
                                     getattr(sol.traj, f.name))
                        for f in dataclasses.fields(State)})
    mu = torch.where(improved,
                     torch.clamp(sol.mu / cfg.mu_factor, min=cfg.mu_min),
                     torch.clamp(sol.mu * cfg.mu_factor ** 2,
                                 max=cfg.mu_max))
    cost = torch.where(improved, cbest, cost0)
    return ILQRState(traj=new_traj, K=K, k=k, mu=mu), cost, sel


def iterate_tassa(model: Model, cost_fn: CostFn, x0: State,
                  sol: ILQRState, cfg: ILQRConfig):
    """One modern iLQG iteration for every instance: linearize the stored
    trajectory, regularized backward pass, and the parallel backtracking
    linesearch.  Returns (solver state, (B,) cost)."""
    lin = linearize_traj(model, sol.traj, cost_fn, cfg.lin)
    K, k, _, _, ok = backward_pass_tassa(model, sol.traj, lin, cost_fn,
                                         sol.mu, cfg)
    trajs, costs = linesearch_rollouts(model, cost_fn, x0, sol, K, k, cfg)
    sol, cost, _ = linesearch_select(cost_fn, sol, K, k, ok, trajs, costs,
                                     cfg)
    return sol, cost


def solve(model: Model, cost_fn: CostFn, x0: State, sol: ILQRState,
          cfg: ILQRConfig) -> Tuple[ILQRState, torch.Tensor]:
    """Run cfg.iterations iLQR iterations from x0 (the reference's
    ``for i<maxIterUtilConvergence: iterate()`` loop,
    src/inverted_pendulum/inverted_pendulum.cpp:22-23).

    Returns (solver state, (B, iterations) cost trace)."""
    it = iterate_compat if cfg.mode == "compat" else iterate_tassa
    trace = []
    for _ in range(cfg.iterations):
        sol, cost = it(model, cost_fn, x0, sol, cfg)
        trace.append(cost)
    return sol, torch.stack(trace, 1)

