"""Box-constrained QP solver (projected Newton) for control-limited iLQG:
the port of ``ilqg_mujoco_tpu/ops/boxqp.py``.

Tassa, Mansard & Todorov, "Control-Limited Differential Dynamic
Programming" (ICRA 2014): at each knot the backward pass solves

    min_x  0.5 x^T Q x + g^T x   s.t.  lo <= x <= hi

with a projected-Newton active-set method; feedback gains are then computed
on the free subspace only (clamped controls get zero feedback rows).

Batched like the rest of the port (any leading dims), with a fixed number
of iterations, the active set as a boolean mask, and the free-subspace
Newton system solved by masking Q to the identity on clamped rows/cols.
Q is SPD by construction (Quu + mu*I), so the masked system is too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import linalg


class BoxQPOut(NamedTuple):
    x: torch.Tensor        # (..., n) argmin, inside the box
    free: torch.Tensor     # (..., n) bool: dims NOT clamped at a bound
    Lfree: torch.Tensor    # (..., n, n) Cholesky factor of the masked system
    pd: torch.Tensor       # (...) bool: masked system was positive definite


def first_argmin(v: torch.Tensor) -> torch.Tensor:
    """Index of the minimum over the last dim, as ``jnp.argmin`` picks it on
    every device: the first NaN if there is one, else the first of tied
    minima."""
    m = v.amin(-1, keepdim=True)          # NaN if any entry is NaN
    hit = (v == m) | (torch.isnan(v) & torch.isnan(m))
    idx = torch.arange(v.shape[-1], device=v.device).expand_as(v)
    return torch.where(hit, idx, v.shape[-1]).amin(-1)


def _masked_system(Q: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Q restricted to the free subspace, identity on clamped dims: solving
    with it equals solving the free-subspace subsystem and returning 0 on
    clamped dims."""
    f = free.to(Q.dtype)
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    return (Q * (f[..., :, None] * f[..., None, :])
            + eye * (1.0 - f[..., None, :]))


def _factor(Q: torch.Tensor, free: torch.Tensor):
    """Cholesky factor of the masked system, the identity where it is not
    PD, and the PD flag."""
    L = linalg.cholesky(_masked_system(Q, free))
    pd = torch.isfinite(L).all(-1).all(-1)
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    return torch.where(pd[..., None, None], L, eye), pd


def boxqp(Q: torch.Tensor, g: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor, x0: torch.Tensor, iters: int = 8,
          alphas=(1.0, 0.5, 0.25, 0.1, 0.05)) -> BoxQPOut:
    """Minimize 0.5 x'Qx + g'x over the box [lo, hi] from warm start x0.

    Fixed ``iters`` projected-Newton steps; each step (a) identifies the
    active set from the current gradient, (b) takes a Newton step on the
    free subspace, (c) projects a fixed alpha grid onto the box and keeps
    the best objective.  With an unbounded box one iteration reproduces the
    unconstrained Newton solve -Q^{-1} g exactly."""
    dt = Q.dtype
    eps = 1e-8
    x = torch.minimum(torch.maximum(x0, lo), hi)
    al = torch.tensor(alphas, dtype=dt, device=Q.device)[:, None]

    def obj(x):
        return 0.5 * linalg.dot(x, linalg.mv(Q, x)) + linalg.dot(g, x)

    def free_set(x):
        grad = g + linalg.mv(Q, x)
        clamped = (((x <= lo + eps) & (grad > 0))
                   | ((x >= hi - eps) & (grad < 0)))
        return grad, ~clamped

    for _ in range(iters):
        grad, free = free_set(x)
        Ls, _ = _factor(Q, free)
        dx = -linalg.cho_solve(Ls, torch.where(free, grad, 0.0))
        # candidates along a new dim before the vector dim: (..., nalpha, n)
        cands = torch.minimum(torch.maximum(
            x[..., None, :] + al * dx[..., None, :], lo[..., None, :]),
            hi[..., None, :])
        vals = (0.5 * linalg.dot(cands, linalg.mv(Q[..., None, :, :], cands))
                + linalg.dot(g[..., None, :], cands))
        best = first_argmin(vals)
        pick = torch.take_along_dim(cands, best[..., None, None],
                                    -2)[..., 0, :]
        vbest = torch.take_along_dim(vals, best[..., None], -1)[..., 0]
        x = torch.where((vbest < obj(x))[..., None], pick, x)

    # final active set + factor (for the caller's feedback-gain solves)
    _, free = free_set(x)
    Ls, pd = _factor(Q, free)
    return BoxQPOut(x=x, free=free, Lfree=Ls, pd=pd)
