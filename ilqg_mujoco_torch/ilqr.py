"""iLQR trajectory optimizer in the reference's compat mode: the port of
``ilqg_mujoco_tpu/ilqr.py`` (reference inc/ilqr.h).

Every function works on a batch of independent instances: a State has a
leading batch dim B, a trajectory is (B, N+1, ...).  Each iteration is

1. ``forward_pass`` — a loop over the horizon applying the affine policy
   u = K (x - x*) + k + u* and stepping the full physics
   (inc/ilqr.h:116-130);
2. ``linearize_traj`` — all N+1 knots of all instances linearized in one
   batched pass (ops/linearize.py);
3. the compat Riccati backward pass (inc/ilqr.h:133-176), quirks included:
   fixed LM shift mu added to V and never removed, rank-1 Hessians
   Q = q q^T and R = r r^T, the knot-gap term c = x*_{t+1} - x*_t, full
   magnitude k, and unused terminal gains.  For nu = 1 it runs in the
   hand-written CUDA kernel (``kernels/riccati.py``) on the card and in that
   kernel's plain version on the CPU; for nu > 1 in
   :func:`backward_pass_compat`.

Time indexing is forward (t=0 initial, t=N terminal); knot t carries the
ctrl applied at it.  The tassa mode comes in slice 2.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .kernels import riccati
from .ops import linalg
from .ops.linearize import CostFn, LinearizeConfig, LinOut, linearize_traj
from .physics import forward as fwd
from .physics.model import Model, State, stack_states


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 20                 # N (inverted_pendulum.h:22)
    iterations: int = 10              # per solve (inverted_pendulum.h:24)
    mode: str = "compat"              # 'compat' ('tassa' in slice 2)
    mu: float = 1000.0                # fixed LM shift (inc/ilqr.h:65)
    lin: LinearizeConfig = LinearizeConfig()
    reg_init: float = 1e-6            # initial ILQRState.mu

    def __post_init__(self):
        if self.mode == "tassa":
            raise NotImplementedError(
                "mode='tassa' is not ported yet: slice 2")
        if self.mode != "compat":
            raise ValueError(f"unknown mode {self.mode!r}")


class ILQRState(NamedTuple):
    """Persistent solver state (the ILQR object's data, inc/ilqr.h:44-65)."""
    traj: State            # (B, N+1, ...) knots, knot t carries its ctrl u_t
    K: torch.Tensor        # (B, N+1, nu, 2nv)
    k: torch.Tensor        # (B, N+1, nu)
    mu: torch.Tensor       # (B,) LM parameter (tassa mode)


def state_diff(model: Model, s_qpos, s_qvel, r_qpos, r_qvel) -> torch.Tensor:
    """Tangent-space state difference x - x* in R^{2nv}: the reference's
    contiguous [qpos; qvel] subtraction (inc/ilqr.h:90,126)."""
    if model.nq != model.nv:
        raise NotImplementedError(
            "quaternion state differences are not ported yet: slice 4")
    return torch.cat([s_qpos - r_qpos, s_qvel - r_qvel], -1)


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
    nonlinear dynamics (inc/ilqr.h:116-130).  Each knot is stored before
    it is stepped; the step after the terminal knot is never used and not
    taken."""
    ref = sol.traj
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
    T = lambda X: X.transpose(-1, -2)
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
        V = 0.5 * (V + T(V))
        Q = outer(q, q)
        R = outer(r, r)
        V = V + cfg.mu * eye                     # shift never removed (:168)
        # reference: (-2 B^T V B - 2R).ldlt() (inc/ilqr.h:167); -T is SPD
        # under the LM shift, so solve the negated system with Cholesky
        negT = 2.0 * T(B) @ V @ B + 2.0 * R
        Lt = linalg.cholesky(negT)
        K = -linalg.cho_solve(Lt, 2.0 * T(B) @ V @ A)
        k = -linalg.cho_solve(Lt, linalg.mv(T(B), v + 2.0 * linalg.mv(V, c))
                              + r)
        ABK = A + B @ K
        V_new = T(ABK) @ V @ ABK + Q + T(K) @ R @ K
        # the reference assigns *V first and the *v update then reads the
        # NEW V (inc/ilqr.h:173-174): replicated deliberately
        v = (2.0 * vm(vm(linalg.mv(B, k) + c, V_new), ABK) + vm(v, ABK) + q
             + 2.0 * vm(vm(k, R), K))
        V = V_new
        Ks[t], ks[t] = K, k
    Ks.append(torch.zeros((Bsz, nu, nv2), dtype=dt, device=dev))
    ks.append(torch.zeros((Bsz, nu), dtype=dt, device=dev))
    return torch.stack(Ks, 1), torch.stack(ks, 1)


def backward_compat(model: Model, traj: State, lin: LinOut, cfg: ILQRConfig):
    """The compat backward pass as the main path runs it: the Riccati
    kernel for nu = 1 (the reference's only complete env), the general
    :func:`backward_pass_compat` otherwise."""
    if model.nu != 1:
        return backward_pass_compat(model, traj, lin, cfg)
    N = cfg.horizon
    K, k = riccati.backward_compat_batched(
        lin.A[:, :N], lin.B[:, :N], lin.gx, lin.gu[:, :N],
        knot_gaps(model, traj), cfg.mu)
    Bsz, nv2 = K.shape[0], K.shape[-1]
    K = torch.cat([K, K.new_zeros((Bsz, 1, 1, nv2))], 1)
    k = torch.cat([k, k.new_zeros((Bsz, 1, 1))], 1)
    return K, k


def iterate_compat(model: Model, cost_fn: CostFn, x0: State,
                   sol: ILQRState, cfg: ILQRConfig):
    """One reference iteration (inc/ilqr.h:179-186): forward then
    backward.  Returns (solver state, (B,) trajectory cost)."""
    traj = forward_pass(model, x0, sol, cfg)
    lin = linearize_traj(model, traj, cost_fn, cfg.lin)
    K, k = backward_compat(model, traj, lin, cfg)
    cost = _traj_cost(cost_fn, traj)
    return ILQRState(traj=traj, K=K, k=k, mu=sol.mu), cost


def solve(model: Model, cost_fn: CostFn, x0: State, sol: ILQRState,
          cfg: ILQRConfig) -> Tuple[ILQRState, torch.Tensor]:
    """Run cfg.iterations iLQR iterations from x0 (the reference's
    ``for i<maxIterUtilConvergence: iterate()`` loop,
    src/inverted_pendulum/inverted_pendulum.cpp:22-23).

    Returns (solver state, (B, iterations) cost trace)."""
    trace = []
    for _ in range(cfg.iterations):
        sol, cost = iterate_compat(model, cost_fn, x0, sol, cfg)
        trace.append(cost)
    return sol, torch.stack(trace, 1)
