"""Batched dense linear algebra for small SPD systems (n <= ~64).

The counterpart of ``ilqg_mujoco_tpu/ops/linalg.py``: a Cholesky unrolled
over the static dimension, written on tensors with any leading batch dims.
``torch.linalg.cholesky`` is not used because it raises on a matrix that is
not positive definite; callers here (and the ``pd`` flags of the tassa
backward pass) expect NaN instead and test with ``isfinite``.

Also the two batched products every module uses: ``mv`` (matrix times
vector) and ``dot``, and ``cho_solve`` by two batched triangular solves.
"""

from __future__ import annotations

import torch


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., m, n) @ (..., n) -> (..., m), broadcasting the leading dims."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the last dim."""
    return (a * b).sum(-1)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower-Cholesky of an SPD matrix, unrolled over the (static) dim.

    Gives NaN (the square root of a negative pivot) when A is not PD."""
    n = A.shape[-1]
    rows = [[None] * n for _ in range(n)]   # rows[i][j] = L[..., i, j]
    for j in range(n):
        s = A[..., j, j]
        if j:
            s = s - (torch.stack(rows[j][:j], -1) ** 2).sum(-1)
        d = torch.sqrt(s)
        rows[j][j] = d
        for i in range(j + 1, n):
            s = A[..., i, j]
            if j:
                s = s - dot(torch.stack(rows[i][:j], -1),
                            torch.stack(rows[j][:j], -1))
            rows[i][j] = s / d
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([rows[i][j] if j <= i else zero
                                     for j in range(n)], -1)
                        for i in range(n)], -2)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = cholesky(A).  b may be a vector (..., n) or a
    matrix (..., n, m) of stacked right-hand sides.  Two batched triangular
    solves: a handful of kernels on the card where the unrolled
    substitution took ~50 (this solve runs in every constraint-solver
    iteration).  A non-finite L gives a non-finite x, as the factor's NaN
    contract needs."""
    vec = b.dim() < L.dim()
    B = b.unsqueeze(-1) if vec else b
    y = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x.squeeze(-1) if vec else x


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD system A x = b."""
    return cho_solve(cholesky(A), b)
