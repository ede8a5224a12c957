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

Inside ``profiling.tracing`` the loop is the span ``cg``, each early-exit
test the span ``cg.sync``, and each capture of a graph the span
``cg.capture``; the counters ``cg.iters``, ``cg.syncs`` and
``cg.captures`` count the iterations run, the tests and the captures, on
the card and the CPU alike.

On the card each iteration is one replay of a CUDA graph captured once per
shape (:class:`_GraphedStep`) and kept in a bounded LRU
(:data:`MAX_GRAPHS`, :func:`clear_graphs`); on the CPU it runs eagerly.
Both run the same operations on the same values.  The cache counts the
replays of each shape, which no dispatch mode sees (``tools/roofline``
counts a replay's work as one :func:`step_into` at its shape).

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

from collections import Counter, OrderedDict
from typing import NamedTuple

import torch

from ..ops import linalg
from ..utils import profiling
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


def step_into(c, carry, tolerance, ls_iterations):
    """One CG iteration written into the ``carry`` tensors: what a replay of
    a captured step runs."""
    for dst, src in zip(carry, _cg_step(c, carry, tolerance, ls_iterations)):
        dst.copy_(src)


class _GraphedStep:
    """One CG iteration captured as a CUDA graph over static buffers: a
    replay launches the ~200 kernels of an iteration at once, where the
    eager loop pays the host's launch cost for each.  The replay runs the
    same kernels on the same values, so the result is the eager one.

    The capture runs under the tensors' own device, on a side stream made
    there: a capture on another device's streams would record nothing, and
    each replay would leave the carry as it was.  :meth:`replay` switches
    to that device as well."""

    def __init__(self, c, carry, tolerance, ls_iterations):
        self.device = carry[0].device
        self.c = tuple(torch.empty_like(t) for t in c)
        self.carry = tuple(torch.empty_like(t) for t in carry)
        self.args = (tolerance, ls_iterations)
        self.load(c, carry)       # the warm-up runs on real values
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):       # warm-up before the capture
                for _ in range(2):
                    self._run()
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                self._run()

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()

    def _run(self):
        step_into(self.c, self.carry, *self.args)

    def load(self, c, carry):
        for dst, src in zip(self.c + self.carry, tuple(c) + tuple(carry)):
            dst.copy_(src)


# one iteration of a tassa path uses 3 shapes (the linearizer's centre and
# tangent solves, the alpha rollout), a compat path 3 (the forward pass, the
# FD centre and perturbations), and an MPC frame adds the env step's
MAX_GRAPHS = 4


def graph_key(c, carry, tolerance, ls_iterations):
    """The cache's key of a CG step: (c's specs, carry's specs, tolerance,
    ls_iterations), a spec (shape, dtype, device)."""
    spec = lambda ts: tuple((tuple(t.shape), t.dtype, str(t.device))
                            for t in ts)
    return spec(c), spec(carry), tolerance, ls_iterations


class _GraphCache:
    """The captured steps, least recently used first, at most ``size`` of
    them: an evicted step's graph and static buffers are dropped, and a
    later solve at its shape captures it again (the same kernels on the
    same values, so the same bits).  Since the last :meth:`clear`, ``keys``
    holds every key captured, ``captures`` counts the captures and
    ``replays`` the replays by key (:func:`graph_key`).  ``capturing`` is
    true while a step is loaded, warmed up and captured: set-up, not the
    solve's work."""

    def __init__(self, size: int):
        self.size = size
        self.steps: OrderedDict = OrderedDict()
        self.keys: set = set()
        self.captures = 0
        self.replays: Counter = Counter()
        self.capturing = False

    def get(self, c, carry, tolerance, ls_iterations) -> tuple:
        """The captured step for these shapes, loaded with ``c`` and
        ``carry`` (one per shape, dtype, device and solver setting), and
        its key."""
        key = graph_key(c, carry, tolerance, ls_iterations)
        if key in self.steps:
            self.steps.move_to_end(key)
        else:
            while len(self.steps) >= self.size:
                self.steps.popitem(last=False)
            self.capturing = True
            try:
                with profiling.span("cg.capture"):
                    self.steps[key] = _GraphedStep(c, carry, tolerance,
                                                   ls_iterations)
                    profiling.count("cg.captures")
            finally:
                self.capturing = False
            self.keys.add(key)
            self.captures += 1
        step = self.steps[key]
        step.load(c, carry)       # the warm-up moved the carry
        return step, key

    def static_bytes(self) -> int:
        """The bytes of the held steps' static buffers (each step's copy
        of ``c = (M, Mfac, qacc_smooth, J, D, aref)`` and of the carry);
        the captured graphs' own memory pools are not counted."""
        return sum(t.numel() * t.element_size()
                   for step in self.steps.values()
                   for t in step.c + step.carry)

    def clear(self):
        self.steps.clear()
        self.keys.clear()
        self.captures = 0
        self.replays.clear()


_GRAPHS = _GraphCache(MAX_GRAPHS)


def clear_graphs():
    """Drop every captured step and release the allocator's cached blocks
    on the current card and on every card that held a captured step (for
    a caller switching to other shapes, or retrying after running out of
    memory)."""
    devices = {dev for key in _GRAPHS.keys for *_, dev in key[0]
               if dev.startswith("cuda")}
    _GRAPHS.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
        for dev in devices:
            with torch.cuda.device(dev):
                torch.cuda.empty_cache()


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
    with profiling.span("cg"):
        if x0.is_cuda:
            graphed, key = _GRAPHS.get(c, carry, tolerance, ls_iterations)
            carry = graphed.carry
        run = tests = 0
        for _ in range(iterations):
            # pinned mode (tolerance 0) runs every iteration,
            # bit-reproducibly; early exit stops once every instance is
            # done, which the host learns from the card
            if tolerance != 0.0:
                tests += 1
                with profiling.span("cg.sync"):
                    finished = bool(carry[5].all())
                if finished:
                    break
            if x0.is_cuda:
                graphed.replay()
                _GRAPHS.replays[key] += 1
            else:
                carry = _cg_step(c, carry, tolerance, ls_iterations)
            run += 1
        profiling.count("cg.iters", run)
        profiling.count("cg.syncs", tests)
    return carry[0].clone(), carry[4].clone()
