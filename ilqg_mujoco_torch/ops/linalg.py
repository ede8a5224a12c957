"""Batched dense linear algebra for small SPD systems (n <= ~64).

The counterpart of ``ilqg_mujoco_tpu/ops/linalg.py``: a Cholesky unrolled
over the static dimension, written on tensors with any leading batch dims.
``torch.linalg.cholesky`` is not used because it raises on a matrix that is
not positive definite; callers here (and the ``pd`` flags of the tassa
backward pass) expect NaN instead and test with ``isfinite``.

Also the two batched products every module uses: ``mv`` (matrix times
vector) and ``dot``.
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


def solve_tri_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b (L lower-triangular), unrolled forward substitution."""
    n = L.shape[-1]
    x = []
    for i in range(n):
        s = b[..., i]
        if i:
            s = s - dot(L[..., i, :i], torch.stack(x, -1))
        x.append(s / L[..., i, i])
    return torch.stack(x, -1)


def solve_tri_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y (back substitution with the lower factor)."""
    n = L.shape[-1]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[..., i]
        if i + 1 < n:
            s = s - dot(L[..., i + 1:, i], torch.stack(x[i + 1:], -1))
        x[i] = s / L[..., i, i]
    return torch.stack(x, -1)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = cholesky(A).  b may be a vector (..., n) or a
    matrix (..., n, m) of stacked right-hand sides."""
    if b.dim() == L.dim():          # matrix RHS: columns as a batch dim
        bt = b.transpose(-1, -2)    # (..., m, n)
        return cho_solve(L.unsqueeze(-3), bt).transpose(-1, -2)
    return solve_tri_upper_t(L, solve_tri_lower(L, b))


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD system A x = b."""
    return cho_solve(cholesky(A), b)
