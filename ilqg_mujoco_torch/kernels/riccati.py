"""Batched compat Riccati backward pass for nu = 1: the hand-written CUDA
kernel ``csrc/riccati_compat.cu`` and its plain PyTorch version.

Replaces the TPU kernel
``ilqg_mujoco_tpu/experimental/pallas_riccati.py::backward_compat_batched``
and keeps its signature and return shapes.  The math is the reference's
compat recursion (reference inc/ilqr.h:133-176) with the gain solve
written as a scalar division, which nu = 1 allows.  The kernel takes every
even n = 2 nv up to ``MAX_N`` (n^2 threads per instance, so n = 32 fills a
block of 1024); its source states its design and its bound.

On a CUDA tensor the wrapper launches the kernel or raises, as it does
for an n the kernel does not take; the plain version, which takes any n,
runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the CUDA kernel in this process; nothing else adds to it
LAUNCHES = 0

MAX_N = 32     # the largest n = 2 nv the kernel takes (every even n up to it)


def backward_compat_batched_ref(A, B, gx, gu, diffs, mu):
    """Plain batched PyTorch version of the kernel, same arithmetic.

    A (Bt, N, n, n), B (Bt, N, n, 1), gx (Bt, N+1, n), gu (Bt, N, 1),
    diffs (Bt, N, n), scalar mu -> K (Bt, N, 1, n), k (Bt, N, 1)."""
    N, n = B.shape[1], B.shape[2]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    v = gx[:, N]
    V = v[:, :, None] * v[:, None, :]
    Ks, ks = [None] * N, [None] * N
    for t in reversed(range(N)):
        a, b = A[:, t], B[:, t, :, 0]
        q, c, r = gx[:, t], diffs[:, t], gu[:, t, 0]
        R = r * r
        V = 0.5 * (V + V.transpose(1, 2)) + mu * eye
        u = (V * b[:, None, :]).sum(-1)                    # V b
        invT = 1.0 / (2.0 * (b * u).sum(-1) + 2.0 * R)
        Kt = -invT[:, None] * 2.0 * (u[:, :, None] * a).sum(1)
        kt = -invT * ((b * v).sum(-1) + 2.0 * (u * c).sum(-1) + r)
        abk = a + b[:, :, None] * Kt[:, None, :]
        P = (V[:, :, :, None] * abk[:, None, :, :]).sum(2)     # V abk
        V = ((abk[:, :, :, None] * P[:, :, None, :]).sum(1)    # abk^T P
             + q[:, :, None] * q[:, None, :]
             + Kt[:, :, None] * R[:, None, None] * Kt[:, None, :])
        w = b * kt[:, None] + c
        y = (w[:, :, None] * V).sum(1)
        v = (2.0 * (y[:, :, None] * abk).sum(1) + (v[:, :, None] * abk).sum(1)
             + q + 2.0 * kt[:, None] * R[:, None] * Kt)
        Ks[t], ks[t] = Kt, kt
    return torch.stack(Ks, 1)[:, :, None, :], torch.stack(ks, 1)[:, :, None]


def _check(A, B, gx, gu, diffs):
    Bt, N, n, nu = B.shape
    if nu != 1:
        raise ValueError(f"the compat Riccati kernel takes nu=1, got {nu}")
    want = {"A": (Bt, N, n, n), "gx": (Bt, N + 1, n), "gu": (Bt, N, 1),
            "diffs": (Bt, N, n)}
    for name, x in (("A", A), ("gx", gx), ("gu", gu), ("diffs", diffs)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {want[name]}")
    for x in (A, gx, gu, diffs):
        if x.device != B.device or x.dtype != B.dtype:
            raise ValueError("all inputs must share one device and dtype")
    return Bt, N, n


def _batch_stride(name, x):
    """The batch stride of a tensor whose per-instance block is contiguous
    (a slice along dim 1 of a contiguous tensor qualifies)."""
    if x.shape[0] and not x[0].is_contiguous():
        raise ValueError(f"{name}: each instance's block must be contiguous")
    return x.stride(0)


def _entry(f64: bool):
    """The C entry point for the dtype, with its argument types declared."""
    lib = _build.load("riccati_compat")
    fn = lib.riccati_compat_f64 if f64 else lib.riccati_compat_f32
    if fn.argtypes is None:
        scalar = ctypes.c_double if f64 else ctypes.c_float
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 5
                       + [scalar, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def backward_compat_batched(A, B, gx, gu, diffs, mu):
    """Batched compat backward pass for nu = 1.

    Args (batch-major):
      A     (Bt, N, n, n)   discrete state Jacobians, knots 0..N-1
      B     (Bt, N, n, 1)   control Jacobians
      gx    (Bt, N+1, n)    cost gradients (gx[:, N] is the terminal initV)
      gu    (Bt, N, 1)      cost ctrl-gradients
      diffs (Bt, N, n)      knot gaps x*_{t+1} - x*_t
      mu    float           fixed LM shift (inc/ilqr.h:65)

    Returns K (Bt, N, 1, n), k (Bt, N, 1); terminal gains are not appended.
    """
    global LAUNCHES
    Bt, N, n = _check(A, B, gx, gu, diffs)
    if A.device.type == "cpu":
        return backward_compat_batched_ref(A, B, gx, gu, diffs, mu)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {A.dtype}")
    if n % 2 or not 2 <= n <= MAX_N:
        raise ValueError(f"the kernel takes even n = 2 nv from 2 to {MAX_N},"
                         f" got n={n}")
    strides = [_batch_stride(name, x) for name, x in
               (("A", A), ("B", B), ("gx", gx), ("gu", gu), ("diffs", diffs))]
    K = torch.empty((Bt, N, 1, n), dtype=A.dtype, device=A.device)
    k = torch.empty((Bt, N, 1), dtype=A.dtype, device=A.device)
    fn = _entry(A.dtype == torch.float64)
    args = []
    for x, s in zip((A, B, gx, gu, diffs), strides):
        args += [x.data_ptr(), s]
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        rc = fn(*args, float(mu), K.data_ptr(), k.data_ptr(), Bt, N, n,
                stream)
    if rc != 0:
        raise RuntimeError(f"riccati_compat launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return K, k
