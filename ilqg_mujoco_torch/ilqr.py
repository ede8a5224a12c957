"""iLQR/iLQG trajectory optimizer: the port of ``ilqg_mujoco_tpu/ilqr.py``
(reference inc/ilqr.h).

Every function works on a batch of independent instances: a State has a
leading batch dim B, a trajectory is (B, N+1, ...), and every per-instance
scalar (``mu``, ``ok``, the costs) is a (B,) tensor.

Modes
-----
* ``compat`` — the reference's recursion, quirks included: fixed LM shift
  mu added to V and never removed, rank-1 Hessians Q = q q^T and
  R = r r^T, the knot-gap term c = x*_{t+1} - x*_t, full magnitude k, and
  unused terminal gains.  Each iteration is ``forward_pass``, then
  ``linearize_traj``, then the backward pass, which for nu = 1 and
  2 nv <= 32 runs in the hand-written CUDA kernel (``kernels/riccati.py``)
  on the card and in that kernel's plain version on the CPU, and in
  :func:`backward_pass_compat` for every other shape.
* ``tassa`` — modern iLQG: exact cost quadratics by autodiff, adaptive
  Levenberg-Marquardt regularization, and a parallel backtracking
  linesearch (every alpha of the grid rolled out at once as one batch of
  len(alphas)+1 times B instances, the best accepted).  The backward pass
  is the sequential recursion (``backward="scan"``, optionally
  control-limited through boxQP and value-scaled) or the log-depth
  associative scan (``backward="assoc"``).

Time indexing is forward (t=0 initial, t=N terminal); knot t carries the
ctrl applied at it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch import func

from .kernels import riccati
from .ops import linalg
from .ops.boxqp import boxqp, first_argmin
from .ops.linearize import (CostFn, LinearizeConfig, LinOut, _qpos_diff,
                            linearize_traj)
from .physics import forward as fwd
from .physics.model import Model, State, device_arrays, stack_states


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 20                 # N (inverted_pendulum.h:22)
    iterations: int = 10              # per solve (inverted_pendulum.h:24)
    mode: str = "compat"              # 'compat' | 'tassa'
    mu: float = 1000.0                # fixed LM shift (inc/ilqr.h:65)
    lin: LinearizeConfig = LinearizeConfig()
    # tassa-mode options
    mu_min: float = 1e-6
    mu_max: float = 1e10
    mu_factor: float = 1.6
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.05, 0.01)
    reg_init: float = 1e-6            # initial ILQRState.mu
    # backward-pass executor (tassa mode): 'scan' = sequential reverse loop;
    # 'assoc' = associative-scan Riccati in O(log N) depth
    backward: str = "scan"
    # control-limited iLQG (Tassa/Mansard/Todorov ICRA 2014): respect the
    # actuator ctrlrange through boxQP in the backward pass and a clip in
    # the rollout.  tassa+scan only.
    control_limits: bool = False
    boxqp_iters: int = 8
    # scaled value recursion (tassa+scan): carry V/s with log s tracked
    # separately, renormalizing every step.  Exact in infinite precision
    # (gains depend only on value/cost ratios); removes the float32 Vxx
    # overflow of long stiff horizons.
    value_scaling: bool = False

    def __post_init__(self):
        if self.mode not in ("compat", "tassa"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.backward not in ("scan", "assoc"):
            raise ValueError(f"unknown backward {self.backward!r}")
        if self.control_limits and self.mode != "tassa":
            raise ValueError(
                "control_limits requires mode='tassa': the compat backward "
                "pass is the reference recursion, which is limit-blind — "
                "clipping only the rollout would silently optimize controls "
                "the backward pass never sees")
        if self.control_limits and self.backward != "scan":
            raise ValueError(
                "control_limits requires backward='scan': the boxQP active "
                "set couples knots sequentially, which the associative-scan "
                "value recursion cannot express")
        if self.value_scaling and self.backward != "scan":
            raise ValueError(
                "value_scaling requires backward='scan': the associative-"
                "scan elements carry unnormalized value quadratics, so the "
                "flag would be silently ignored")


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


def ctrl_bounds(model: Model, dtype, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Per-actuator (lo, hi) ctrl bounds; unlimited actuators get a huge
    finite box (keeps boxQP arithmetic NaN-free)."""
    c = device_arrays(model, device, dtype)
    big = torch.tensor(1e9, dtype=dtype, device=device)
    lim = c.actuator_ctrllimited
    return (torch.where(lim, c.actuator_ctrlrange[:, 0], -big),
            torch.where(lim, c.actuator_ctrlrange[:, 1], big))


def forward_pass(model: Model, x0: State, sol: ILQRState,
                 cfg: ILQRConfig, alpha=1.0) -> State:
    """Roll out u = K (x - x*) + alpha*k + u* from x0 through the full
    nonlinear dynamics (inc/ilqr.h:116-130).  ``alpha`` is a scalar or a
    (B,) tensor, one step size per instance.  Each knot is stored before
    it is stepped; the step after the terminal knot is never used and not
    taken.

    With ``control_limits`` the policy output is clipped to the actuator
    box, so the stored (and costed) controls are the ones the plant
    applies."""
    ref = sol.traj
    if torch.is_tensor(alpha) and alpha.dim() == 1:
        alpha = alpha[:, None]
    if cfg.control_limits:
        lo, hi = ctrl_bounds(model, sol.k.dtype, sol.k.device)
    knots, s = [], x0
    for t in range(cfg.horizon + 1):
        dx = state_diff(model, s.qpos, s.qvel, ref.qpos[:, t], ref.qvel[:, t])
        u = linalg.mv(sol.K[:, t], dx) + alpha * sol.k[:, t] + ref.ctrl[:, t]
        if cfg.control_limits:
            u = torch.minimum(torch.maximum(u, lo), hi)
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


def backward_compat(model: Model, traj: State, lin: LinOut, cfg: ILQRConfig):
    """The compat backward pass as the main path runs it, chosen by shape:
    the Riccati kernel's wrapper for nu = 1 and 2 nv <= ``riccati.MAX_N``
    (the cart-pole; on the CPU the wrapper runs its plain version), the
    general :func:`backward_pass_compat` for every other shape."""
    if model.nu != 1 or 2 * model.nv > riccati.MAX_N:
        return backward_pass_compat(model, traj, lin, cfg)
    N = cfg.horizon
    K, k = riccati.backward_compat_batched(
        lin.A[:, :N], lin.B[:, :N], lin.gx, lin.gu[:, :N],
        knot_gaps(model, traj), cfg.mu)
    Bsz, nv2 = K.shape[0], K.shape[-1]
    K = torch.cat([K, K.new_zeros((Bsz, 1, 1, nv2))], 1)
    k = torch.cat([k, k.new_zeros((Bsz, 1, 1))], 1)
    return K, k


# ---------------------------------------------------------------------------
# tassa backward pass: proper iLQG
# ---------------------------------------------------------------------------

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
    if cfg.control_limits:
        ulo, uhi = ctrl_bounds(model, dt, dev)
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
        if cfg.control_limits:
            # k from the boxQP over du in [lo-u*, hi-u*]; feedback only on
            # the free subspace (clamped controls get zero K rows)
            u_t = ctrl[:, t]
            qp = boxqp(Quu_reg, Qu, ulo - u_t, uhi - u_t,
                       torch.zeros_like(u_t), iters=cfg.boxqp_iters)
            pd, k = qp.pd, qp.x
            K = -linalg.cho_solve(qp.Lfree, torch.where(
                qp.free[..., :, None], Qux, 0.0))
        else:
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


# ---------------------------------------------------------------------------
# associative-scan (parallel) Riccati backward pass
# ---------------------------------------------------------------------------

def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B by batched LU (B a matrix); singular systems give inf/NaN
    instead of raising, as ``jnp.linalg.solve`` does."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _lqr_combine(e2, e1):
    """Associative combination of conditional-value-function elements.

    Element semantics (Särkkä & García-Fernández, temporal parallelization
    of LQT): E = (A, b, C, eta, J) represents the optimal cost of steering
    the linearized system from start state x to end state z,
        f(x, z) = 0.5 x^T J x - eta^T x
                  + max_lam [lam^T (z - A x - b) - 0.5 lam^T C lam],
    and f12(x, z) = min_y f1(x, y) + f2(y, z) has the same form with the
    closed-form parameters below (only I + C1 J2 is inverted: always
    nonsingular for PSD C, J).  ``e2`` is the later element, ``e1`` the
    earlier; the result is earlier∘later.  Batched over any leading dims."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    col = lambda v: v[..., None]
    M = eye + C1 @ J2
    Minv_A1 = _solve(M, A1)
    Minv_bCeta = _solve(M, col(b1 + linalg.mv(C1, eta2)))[..., 0]
    Nt = eye + J2 @ C1
    Ntinv_eta = _solve(Nt, col(eta2 - linalg.mv(J2, b1)))[..., 0]
    Ntinv_JA = _solve(Nt, J2 @ A1)
    return (A2 @ Minv_A1,
            linalg.mv(A2, Minv_bCeta) + b2,
            A2 @ _solve(M, C1) @ _T(A2) + C2,
            linalg.mv(_T(A1), Ntinv_eta) + eta1,
            _T(A1) @ Ntinv_JA + J1)


def _suffix_scan(combine, elems):
    """Inclusive reverse scan over dim 1 in log depth (Hillis-Steele):
    out[t] = elems[t] ∘ elems[t+1] ∘ ... ∘ elems[L-1].  Round d combines
    every t with t + d, so after ceil(log2 L) rounds each t covers its
    whole suffix.  ``combine(later, earlier)`` as
    ``lax.associative_scan(..., reverse=True)`` calls it."""
    L = elems[0].shape[1]
    out, d = elems, 1
    while d < L:
        comb = combine(tuple(x[:, d:] for x in out),
                       tuple(x[:, :L - d] for x in out))
        out = tuple(torch.cat([c, x[:, L - d:]], 1)
                    for c, x in zip(comb, out))
        d *= 2
    return out


def backward_pass_assoc(model: Model, traj: State, lin: LinOut,
                        cost_fn: CostFn, mu: torch.Tensor, cfg: ILQRConfig):
    """Parallel (associative-scan) tassa backward pass.

    Equivalent to :func:`backward_pass_tassa` with the LM shift applied to
    every Quu (the sequential pass regularizes only the gain solves, so the
    two coincide as mu -> 0 and agree to O(mu) otherwise).  Same return
    contract: (K, k, dV1, dV2, ok)."""
    N = cfg.horizon
    nv2, nu = 2 * model.nv, model.nu
    dt, dev = lin.A.dtype, lin.A.device
    Bsz = lin.A.shape[0]
    lx, lu, lxx, luu, lux = _cost_quadratics(cost_fn, model, traj)
    eye = torch.eye(nu, dtype=dt, device=dev)
    mu4 = mu[:, None, None, None]

    A, B = lin.A[:, :N], lin.B[:, :N]
    P, p = lxx[:, :N], lx[:, :N]
    R = luu[:, :N] + mu4 * eye
    r, Mx = lu[:, :N], lux[:, :N]

    # stage elements: eliminate u from (cost, dynamics), see _lqr_combine
    Rinv_Bt = _solve(R, _T(B))                         # (B, N, nu, 2nv)
    Rinv_M = _solve(R, Mx)                             # (B, N, nu, 2nv)
    Rinv_r = _solve(R, r[..., None])[..., 0]           # (B, N, nu)
    eA = A - B @ Rinv_M
    eb = -linalg.mv(B, Rinv_r)
    eC = B @ Rinv_Bt
    eJ = P - _T(Mx) @ Rinv_M
    eeta = -(p - linalg.mv(_T(Mx), Rinv_r))

    # terminal element encodes the terminal quadratic
    zA = torch.zeros((Bsz, 1, nv2, nv2), dtype=dt, device=dev)
    elems = (torch.cat([eA, zA], 1),
             torch.cat([eb, torch.zeros((Bsz, 1, nv2), dtype=dt,
                                        device=dev)], 1),
             torch.cat([eC, zA], 1),
             torch.cat([eeta, -lx[:, N:]], 1),
             torch.cat([eJ, lxx[:, N:]], 1))
    suffix = _suffix_scan(_lqr_combine, elems)
    # V_t(x) = 0.5 x^T J_t x - eta_t^T x; gains at t need (J, eta)_{t+1}
    Jn, etan = suffix[4][:, 1:], suffix[3][:, 1:]

    Qu = lu[:, :N] + linalg.mv(_T(B), -etan)
    Quu = luu[:, :N] + _T(B) @ Jn @ B
    Qux = lux[:, :N] + _T(B) @ Jn @ A
    L = linalg.cholesky(Quu + mu4 * eye)
    pd = torch.isfinite(L).all(-1).all(-1)             # (B, N)
    Ls = torch.where(pd[..., None, None], L, eye)
    K = -linalg.cho_solve(Ls, Qux)
    k = -linalg.cho_solve(Ls, Qu)
    dv1 = linalg.dot(k, Qu)
    dv2 = 0.5 * linalg.dot(k, linalg.mv(Quu, k))
    K = torch.cat([K, K.new_zeros((Bsz, 1, nu, nv2))], 1)
    k = torch.cat([k, k.new_zeros((Bsz, 1, nu))], 1)
    return K, k, dv1.sum(1), dv2.sum(1), pd.all(1)


# ---------------------------------------------------------------------------
# solve loops
# ---------------------------------------------------------------------------

def iterate_compat(model: Model, cost_fn: CostFn, x0: State,
                   sol: ILQRState, cfg: ILQRConfig):
    """One reference iteration (inc/ilqr.h:179-186): forward then
    backward.  Returns (solver state, (B,) trajectory cost)."""
    traj = forward_pass(model, x0, sol, cfg)
    lin = linearize_traj(model, traj, cost_fn, cfg.lin)
    K, k = backward_compat(model, traj, lin, cfg)
    cost = _traj_cost(cost_fn, traj)
    return ILQRState(traj=traj, K=K, k=k, mu=sol.mu), cost


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
    bwd = (backward_pass_assoc if cfg.backward == "assoc"
           else backward_pass_tassa)
    K, k, _, _, ok = bwd(model, sol.traj, lin, cost_fn, sol.mu, cfg)
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
