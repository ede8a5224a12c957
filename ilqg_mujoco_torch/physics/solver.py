"""Projected-CG constraint solver (primal, batched).

The port of ``ilqg_mujoco_tpu/physics/solver.py``.  Solves
    min_x  0.5 (x - a_s)^T M (x - a_s) + 0.5 sum_i D_i [Jx - aref]_i-^2
over qacc = x with M^-1-preconditioned Polak-Ribiere CG and an exact
linesearch (Newton steps on the piecewise-quadratic 1-D restriction).

Two modes, as in the reference:

* pinned (``tolerance == 0``): exactly ``iterations`` iterations for every
  instance — the FD determinism protocol
  (reference src/mjderivative.cpp:241-242);
* early exit (``tolerance > 0``): each instance stops once
  sqrt(g . M^-1 g) < tolerance.  This reproduces ``jax.vmap`` of a
  ``lax.while_loop``: the body runs while any instance is active, and an
  instance that has finished keeps its values (a per-instance mask selects
  old or new on every carried tensor), so every instance gets exactly the
  iterates it would get alone.  The loop asks the host once per iteration
  whether any instance is still active.

Forward-mode AD (``torch.autograd.forward_ad``, which the ``ad`` and
``exact`` linearizers use) does not run through the CG iterations: the
solve is a ``torch.autograd.Function`` whose ``jvp`` differentiates the
optimality condition at the solution (see :class:`_SolveQacc`).  Without
dual tensors the Function returns what ``_solve_cg`` returns, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg
from .constraint import Efc


class SolveOut(NamedTuple):
    qacc: torch.Tensor
    qfrc_constraint: torch.Tensor
    niter: torch.Tensor      # (...) int32 iterations run per instance


def solve(M: torch.Tensor, Mfac, qacc_smooth: torch.Tensor, efc: Efc,
          warmstart: torch.Tensor, iterations: int, tolerance: float,
          ls_iterations: int = 8) -> SolveOut:
    if efc.J.shape[-2] == 0:
        return SolveOut(qacc_smooth, torch.zeros_like(qacc_smooth),
                        torch.zeros(qacc_smooth.shape[:-1], dtype=torch.int32,
                                    device=qacc_smooth.device))
    x, niter = _SolveQacc.apply(M, Mfac, qacc_smooth, efc.J, efc.D,
                                efc.aref, warmstart, iterations, tolerance,
                                ls_iterations)
    jar = linalg.mv(efc.J, x) - efc.aref
    f = torch.where(jar < 0, -efc.D * jar, torch.zeros_like(jar))
    qfrc_constraint = linalg.mv(efc.J.transpose(-1, -2), f)
    return SolveOut(x, qfrc_constraint, niter.to(torch.int32))


class _SolveQacc(torch.autograd.Function):
    """qacc from the projected-CG solver, with *implicit differentiation*
    in forward mode (the port of the JAX package's ``_solve_qacc`` custom
    JVP).

    Differentiating through the unrolled CG iterations is wasteful (tangents
    propagate through every iteration) and unstable: in float32 the
    amplified tangent noise produced NaN humanoid Jacobians.  With the
    active set A = {i : J_i x < aref_i, D_i > 0} frozen at the solution,
        R(x) = M (x - a_s) + J_A^T D_A (J_A x - aref_A) = 0,
    so (M + J_A^T D_A J_A) dx = -dR|_x: one SPD solve per tangent.  The
    tangents of ``Mfac`` and ``warmstart`` are discarded; ``niter`` (carried
    as a float) is not differentiable."""

    @staticmethod
    def forward(M, Mfac, qacc_smooth, J, D, aref, warmstart, iterations,
                tolerance, ls_iterations):
        return _solve_cg(M, Mfac, qacc_smooth, J, D, aref, warmstart,
                         iterations, tolerance, ls_iterations)

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, _, qacc_smooth, J, D, aref = inputs[:6]
        x, niter = output
        ctx.save_for_forward(M, qacc_smooth, J, D, aref, x)
        ctx.mark_non_differentiable(niter)

    @staticmethod
    def jvp(ctx, dM, _dMfac, dqs, dJ, dD, daref, _dwarm, *_static):
        M, qacc_smooth, J, D, aref, x = ctx.saved_tensors
        Jt = J.transpose(-1, -2)
        jar = linalg.mv(J, x) - aref
        act = (jar < 0) & (D > 0)
        zero = torch.zeros_like(jar)
        Deff = torch.where(act, D, zero)
        H = M + Jt @ (Deff[..., :, None] * J)
        # dtype-relative ridge: at deeply penetrating states the stiffened
        # H has cond ~ 1/eps_f32 and the Cholesky hits a negative pivot;
        # the ridge caps the condition number at ~1/ridge_rel and perturbs
        # tangents ~ridge_rel relatively
        ridge_rel = 1e-6 if H.dtype == torch.float32 else 1e-12
        dmax = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1).abs()
                           .amax(-1), min=1.0)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        H = H + (ridge_rel * dmax)[..., None, None] * eye
        # an input without a tangent gets zeros (materialized)
        dR = (linalg.mv(dM, x - qacc_smooth) - linalg.mv(M, dqs)
              + linalg.mv(dJ.transpose(-1, -2), Deff * jar)
              + linalg.mv(Jt, torch.where(act, dD, zero) * jar)
              + linalg.mv(Jt, Deff * (linalg.mv(dJ, x) - daref)))
        dx = -linalg.cho_solve(linalg.cholesky(H), dR)
        return dx, None


def _solve_cg(M, Mfac, qacc_smooth, J, D, aref, warmstart,
              iterations, tolerance, ls_iterations):
    dt = qacc_smooth.dtype
    Jt = J.transpose(-1, -2)
    zero = torch.zeros((), dtype=dt, device=qacc_smooth.device)

    def cost(x):
        dx = x - qacc_smooth
        jar = linalg.mv(J, x) - aref
        pen = torch.where(jar < 0, jar, zero)
        return (0.5 * linalg.dot(dx, linalg.mv(M, dx))
                + 0.5 * (D * pen * pen).sum(-1))

    def grad(x):
        dx = x - qacc_smooth
        jar = linalg.mv(J, x) - aref
        f = torch.where(jar < 0, D * jar, zero)
        return linalg.mv(M, dx) + linalg.mv(Jt, f)

    # MuJoCo warmstart policy: start from the better of (qacc_warmstart,
    # qacc_smooth)
    x0 = torch.where((cost(warmstart) < cost(qacc_smooth))[..., None],
                     warmstart, qacc_smooth)

    def linesearch(x, p):
        """Exact minimization of the piecewise quadratic along p."""
        Jp = linalg.mv(J, p)
        jar0 = linalg.mv(J, x) - aref
        pMp = linalg.dot(p, linalg.mv(M, p))
        pMdx = linalg.dot(p, linalg.mv(M, x - qacc_smooth))
        DJpJp = D * Jp * Jp
        alpha = torch.zeros_like(pMp)
        for _ in range(ls_iterations):
            jar = jar0 + alpha[..., None] * Jp
            act = jar < 0
            d1 = pMdx + alpha * pMp + torch.where(act, D * jar * Jp,
                                                  zero).sum(-1)
            d2 = pMp + torch.where(act, DJpJp, zero).sum(-1)
            alpha = alpha - d1 / torch.clamp(d2, min=1e-15)
        return alpha

    def cg_body(x, g, Mg, p, it):
        alpha = linesearch(x, p)
        x_new = x + alpha[..., None] * p
        g_new = grad(x_new)
        Mg_new = linalg.cho_solve(Mfac, g_new)
        beta = torch.clamp(linalg.dot(g_new, Mg_new - Mg)
                           / torch.clamp(linalg.dot(g, Mg), min=1e-15),
                           min=0.0)
        p_new = -Mg_new + beta[..., None] * p
        done = torch.sqrt(linalg.dot(g_new, Mg_new)) < tolerance
        return x_new, g_new, Mg_new, p_new, it + 1, done

    g = grad(x0)
    Mg = linalg.cho_solve(Mfac, g)
    x, p = x0, -Mg
    it = torch.zeros(x0.shape[:-1], dtype=dt, device=x0.device)
    if tolerance == 0.0:
        # pinned mode: static trip count, bit-reproducible
        for _ in range(iterations):
            x, g, Mg, p, it, _ = cg_body(x, g, Mg, p, it)
        return x, it

    done = torch.zeros(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    for _ in range(iterations):
        active = torch.logical_not(done)
        if not bool(active.any()):
            break
        xn, gn, Mgn, pn, itn, donen = cg_body(x, g, Mg, p, it)
        a = active[..., None]
        x = torch.where(a, xn, x)
        g = torch.where(a, gn, g)
        Mg = torch.where(a, Mgn, Mg)
        p = torch.where(a, pn, p)
        it = torch.where(active, itn, it)
        done = torch.where(active, donen, done)
    return x, it
