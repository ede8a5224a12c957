"""The work a solve needs: the Riccati kernel's bytes and a floor on the
floating-point operations of one iLQR iteration, both from the
configuration's dimensions alone.

``riccati_work`` is a copy of the program's ``kernels/riccati.work``: the
recursion's operations and each input read once and each output written
once, for one launch over ``Bt`` instances of ``N`` steps at n = 2 nv.

``iteration_flops`` counts, per instance, the dense algebra that the
algorithm itself needs in one iteration, however it is implemented: for
every state evaluation the mass matrix (one 6-vector dot product, 12
operations, per entry), its Cholesky factorisation (nv^3 / 3) and the
Jacobian products of the constraint solve (J x and J^T f, 4 nefc nv), and
for every CG iteration 4 nefc nv + 4 nv^2 (J p, J^T f, M p and the two
triangular solves of M^-1 g).  The CG runs its pinned count where the
linearizer pins it, and one iteration where it exits early, which is the
least an early exit can take.  Kinematics, collision, the cost and its
quadratics are not counted, so this is a floor: the same algorithm cannot
do less, and a count of what an implementation launches would move with
the implementation.
"""

from __future__ import annotations


def riccati_work(Bt: int, N: int, n: int, itemsize: int):
    """(operations, bytes) of one launch of the compat Riccati kernel."""
    elems = Bt * (N * n * n + N * n + (N + 1) * n + N + N * n  # A B gx gu c
                  + N * n + N)                                  # K k
    ops = Bt * N * (4 * n ** 3 + 15 * n ** 2 + 14 * n + 10)
    return ops, elems * itemsize


def chol(n: int) -> float:
    return n ** 3 / 3


def tri2(n: int, rhs: int = 1) -> float:
    """A forward and a back substitution with ``rhs`` right-hand sides."""
    return 2 * n * n * rhs


def pos_eval(nv: int) -> float:
    """The mass matrix and its factorisation."""
    return 12 * nv * nv + chol(nv)


def cg_iter(nv: int, nefc: int) -> float:
    return 4 * nefc * nv + 2 * nv * nv + tri2(nv)


def acc_eval(nv: int, nefc: int, cg_iters: int) -> float:
    """The smooth acceleration, the solve's Jacobian products and its CG."""
    if nefc == 0:
        return tri2(nv)
    return tri2(nv) + 4 * nefc * nv + cg_iters * cg_iter(nv, nefc)


def state_eval(nv: int, nefc: int, cg_iters: int) -> float:
    return pos_eval(nv) + acc_eval(nv, nefc, cg_iters)


def riccati_compat_step(n: int) -> float:
    return 4 * n ** 3 + 15 * n ** 2 + 14 * n + 10


def tassa_step(n: int, nu: int) -> float:
    """One knot of the sequential tassa recursion: A^T V A, B^T V B, B^T V A,
    the Cholesky of Quu, the gain solves and the value update."""
    return 4 * n ** 3 + 10 * n * n * nu + 6 * n * nu * nu + chol(nu)


def iteration_flops(cfg: dict) -> float:
    """Floor on the operations of one iteration of one instance for the
    configuration ``cfg`` (its JSON file's keys)."""
    nv, nu, nefc, N = cfg["nv"], cfg["nu"], cfg["nefc"], cfg["horizon"]
    lin = cfg["lin"]
    niter, nwarm = lin["niter"], lin["nwarmup"]
    evals_per_step = 4 if cfg["integrator"] == "RK4" else 1
    T = N + 1
    step = evals_per_step * state_eval(nv, nefc, 1)
    center = pos_eval(nv) + nwarm * acc_eval(nv, nefc, niter)
    if lin["engine"] == "fd":
        lin_knot = (center + 2 * nv * pos_eval(nv)
                    + (4 * nv + 2 * nu) * acc_eval(nv, nefc, niter))
    else:   # ad: one tangent solve (M + J^T D J) per knot, each direction
        P = 2 * nv + nu
        lin_knot = (center + 2 * nefc * nv * nv + chol(nv)
                    + P * (4 * nefc * nv + 2 * nv * nv + tri2(nv)))
    if cfg["mode"] == "compat":
        forward = N * step
        backward = N * riccati_compat_step(2 * nv)
    else:
        forward = (len(cfg["alphas"]) + 1) * N * step
        backward = N * tassa_step(2 * nv, nu)
    return forward + T * lin_knot + backward
