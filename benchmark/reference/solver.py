"""Projected-CG constraint solver (primal, batched), eager on every device.

A frozen copy of the program's ``physics/solver.py`` without its CUDA-graph
replays: every CG iteration runs as plain PyTorch operations.  Solves
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

The constraint Jacobian J is per instance, (..., nefc, nv), when the model
has contacts, and one (nefc, nv) for the whole batch when it has limit
rows only; every product broadcasts over the batch dims either way.

Forward-mode AD (``torch.autograd.forward_ad``, which the ``ad`` and
``exact`` linearizers use) does not run through the CG iterations: the
solve is a ``torch.autograd.Function`` whose ``jvp`` differentiates the
optimality condition at the solution (see :class:`_SolveQacc`).  Without
dual tensors the Function returns what ``_solve_cg`` returns, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import linalg
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
    so (M + J_A^T D_A J_A) dx = -dR|_x: one SPD solve per tangent.  With
    contacts J moves with qpos, and its tangent dJ enters dR.  The
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


def _cost(c, x):
    M, _, qacc_smooth, J, D, aref = c
    dx = x - qacc_smooth
    jar = linalg.mv(J, x) - aref
    pen = torch.where(jar < 0, jar, 0.0)
    return (0.5 * linalg.dot(dx, linalg.mv(M, dx))
            + 0.5 * (D * pen * pen).sum(-1))


def _grad(c, x):
    M, _, qacc_smooth, J, D, aref = c
    dx = x - qacc_smooth
    jar = linalg.mv(J, x) - aref
    f = torch.where(jar < 0, D * jar, 0.0)
    return linalg.mv(M, dx) + linalg.mv(J.transpose(-1, -2), f)


# the fused addcmul/addcdiv below launch one kernel where two or three
# would: these loops are the bulk of the kernels a contact step runs
def _linesearch(c, x, p, ls_iterations):
    """Exact minimization of the piecewise quadratic along p."""
    M, _, qacc_smooth, J, D, aref = c
    Jp = linalg.mv(J, p)
    jar0 = linalg.mv(J, x) - aref
    pMp = linalg.dot(p, linalg.mv(M, p))
    pMdx = linalg.dot(p, linalg.mv(M, x - qacc_smooth))
    DJp = D * Jp
    DJpJp = DJp * Jp
    alpha = torch.zeros_like(pMp)
    zero = Jp.new_zeros(())
    for _ in range(ls_iterations):
        jar = torch.addcmul(jar0, alpha[..., None], Jp)
        act = jar < 0
        d1 = torch.addcmul(pMdx, alpha, pMp) + torch.where(
            act, DJp * jar, zero).sum(-1)
        d2 = pMp + torch.where(act, DJpJp, zero).sum(-1)
        alpha = torch.addcdiv(alpha, d1, torch.clamp(d2, min=1e-15),
                              value=-1.0)
    return alpha


def _cg_step(c, carry, tolerance, ls_iterations):
    """One Polak-Ribiere iteration for every instance.  In early-exit mode
    (tolerance > 0) an instance that is done keeps its values."""
    x, g, Mg, p, it, done = carry
    alpha = _linesearch(c, x, p, ls_iterations)
    x_new = torch.addcmul(x, alpha[..., None], p)
    g_new = _grad(c, x_new)
    Mg_new = linalg.cho_solve(c[1], g_new)
    beta = torch.clamp(linalg.dot(g_new, Mg_new - Mg)
                       / torch.clamp(linalg.dot(g, Mg), min=1e-15), min=0.0)
    p_new = torch.addcmul(-Mg_new, beta[..., None], p)
    if tolerance == 0.0:
        return x_new, g_new, Mg_new, p_new, it + 1, done
    done_new = torch.sqrt(linalg.dot(g_new, Mg_new)) < tolerance
    active = torch.logical_not(done)
    a = active[..., None]
    return (torch.where(a, x_new, x), torch.where(a, g_new, g),
            torch.where(a, Mg_new, Mg), torch.where(a, p_new, p),
            torch.where(active, it + 1, it),
            torch.where(active, done_new, done))


def _solve_cg(M, Mfac, qacc_smooth, J, D, aref, warmstart,
              iterations, tolerance, ls_iterations):
    c = (M, Mfac, qacc_smooth, J, D, aref)
    # MuJoCo warmstart policy: start from the better of (qacc_warmstart,
    # qacc_smooth)
    x0 = torch.where((_cost(c, warmstart) < _cost(c, qacc_smooth))[..., None],
                     warmstart, qacc_smooth)
    g = _grad(c, x0)
    Mg = linalg.cho_solve(Mfac, g)
    batch = x0.shape[:-1]
    carry = (x0, g, Mg, -Mg,
             torch.zeros(batch, dtype=x0.dtype, device=x0.device),
             torch.zeros(batch, dtype=torch.bool, device=x0.device))
    for _ in range(iterations):
        # pinned mode (tolerance 0) runs every iteration, bit-reproducibly;
        # early exit stops once every instance is done
        if tolerance != 0.0 and bool(carry[5].all()):
            break
        carry = _cg_step(c, carry, tolerance, ls_iterations)
    return carry[0].clone(), carry[4].clone()
