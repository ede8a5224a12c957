"""The Riccati kernel against the general recursion on the same data: the
counterpart of the JAX package's ``tools/pallas_bench.py``.

    python -m ilqg_mujoco_torch.tools.kernel_bench
    REPS=20 python -m ilqg_mujoco_torch.tools.kernel_bench

The JAX tool timed its Pallas kernel against the XLA scan path, the
recursion the program would otherwise run.  Here the three routes of the
compat backward pass (cart-pole dims: n = 4, nu = 1, N = 20) run on
identical inputs:

- ``kernel``: ``kernels/riccati.backward_compat_batched``, the CUDA kernel
  (on the CPU its plain version);
- ``general_recursion``: ``ilqr.backward_pass_compat``, the batched loop
  of PyTorch ops that the main path runs for every other shape;
- ``plain``: ``riccati.backward_compat_batched_ref``, the kernel's plain
  version.

Data (the JAX tool's recipe): one cart-pole instance at qpos (0.05, 0.2),
its initial trajectory's real linearization (``ilqr.forward_pass``, then
``linearize_traj``), copied over B lanes with 1e-3 standard normal noise
per lane on A, B, gx, gu and on the trajectory's knots (so on its knot
gaps), drawn from a torch generator seeded with 0 and cast to the dtype.

Each route's time is the JAX tool's: the best of 3 loops of ``reps``
calls, each loop timed by ``utils/profiling.Timer`` (on the card CUDA
events, the host's launch cost included); on the card the kernel is also
timed from a CUDA graph with its inputs warm in L2 (``kernel_ms_graph``).
Agreement is the JAX tool's, the kernel's K against the general
recursion's relative to max|K| (median and max), beside the kernel's
largest error against its plain version; in float64 both are held to the
golden tolerances (``riccati.tolerances``) and a miss raises, in float32
the tolerance of ``tests/test_torch_riccati.py`` is reported beside them
(the compat recursion is ill-conditioned, so summation order shows).
``bound_ms`` is the least time of one launch (``riccati.bound_ms``),
``launches`` the kernel's launches in the run (``riccati.LAUNCHES``).

Two shapes by default, one JSON line each: the JAX tool's (float32,
ILQG_BENCH_BATCH, default 8192) and the main path's (float64, B=4096).
Env knobs, as the JAX tool's: ILQG_BENCH_BATCH, REPS (50).  Runs on the
card; only ``main(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from .. import ilqr
from ..kernels import riccati
from ..models import envs
from ..ops.linearize import linearize_traj
from ..physics.model import make_state, resolve_device
from ..utils import profiling

NOISE = 1e-3
NOISE_SEED = 0
QPOS = (0.05, 0.2)
MAIN_BATCH = 4096       # the main path's batch, in float64
LOOPS = 3


def inputs(batch, dtype, device):
    """(env, traj, lin, kernel args) over ``batch`` lanes of the perturbed
    cart-pole linearization (module docstring), in ``dtype`` on
    ``device``."""
    env = envs.pendulum("compat", "fd")
    m, cfg = env.model, env.ilqr
    N = cfg.horizon
    s0 = make_state(m, 1, device="cpu").replace(
        qpos=torch.tensor([QPOS], dtype=torch.float64))
    sol = ilqr.init_solver(m, s0, cfg)
    traj = ilqr.forward_pass(m, s0, sol, cfg)
    lin = linearize_traj(m, traj, env.cost_fn, cfg.lin)
    gen = torch.Generator().manual_seed(NOISE_SEED)

    def lanes(x):
        x = x[0]
        noise = torch.randn((batch,) + x.shape, generator=gen,
                            dtype=torch.float64)
        return (x[None] + NOISE * noise).to(dtype=dtype, device=device)

    lin = lin._replace(A=lanes(lin.A), B=lanes(lin.B), gx=lanes(lin.gx),
                       gu=lanes(lin.gu), cost=lanes(lin.cost))
    qpos, qvel = lanes(traj.qpos), lanes(traj.qvel)
    traj = traj.map(lambda x: x[0].expand((batch,) + x.shape[1:])
                    .to(dtype=dtype, device=device))
    traj = traj.replace(qpos=qpos, qvel=qvel)
    args = (lin.A[:, :N], lin.B[:, :N], lin.gx, lin.gu[:, :N],
            ilqr.knot_gaps(m, traj))
    return env, traj, lin, args


def best_ms(fn, reps, device):
    """The JAX tool's time: ms per call, the best of ``LOOPS`` loops of
    ``reps`` calls after one warm call."""
    fn()
    timer = profiling.Timer(device)
    best = None
    for _ in range(LOOPS):
        with timer.phase("loop") as box:
            for _ in range(reps):
                fn()
        best = box["seconds"] if best is None else min(best, box["seconds"])
    return 1e3 * best / reps


def bench_shape(batch, dtype, reps, device) -> dict:
    """The three routes at one shape; returns the JSON line's dict.  Raises
    if float64 misses the golden tolerances."""
    dev = resolve_device(device)
    launches0 = riccati.LAUNCHES
    env, traj, lin, args = inputs(batch, dtype, dev)
    mu, N, n = env.ilqr.mu, env.ilqr.horizon, args[1].shape[2]
    kernel = lambda: riccati.backward_compat_batched(*args, mu)
    general = lambda: ilqr.backward_pass_compat(env.model, traj, lin,
                                                env.ilqr)
    plain = lambda: riccati.backward_compat_batched_ref(*args, mu)

    K, k = kernel()
    Kg, kg = general()
    Kp, kp = plain()
    Kg, kg = Kg[:, :N], kg[:, :N]
    scale = float(Kg.abs().max())
    rel = ((K - Kg).abs() / scale).flatten().double().cpu()
    kernel_vs_plain = max(float((K - Kp).abs().max()),
                          float((k - kp).abs().max()))
    rtol, atol = riccati.tolerances(dtype, n, Kp)
    within = {name: bool(((got - want).abs()
                          <= atol + rtol * want.abs()).all())
              for name, got, want in (("kernel_vs_plain_K", K, Kp),
                                      ("kernel_vs_plain_k", k, kp),
                                      ("general_vs_plain_K", Kg, Kp),
                                      ("general_vs_plain_k", kg, kp))}
    if dtype == torch.float64 and not all(within.values()):
        raise AssertionError(f"kernel_bench float64 B={batch}: outside the "
                             f"golden tolerances: {within}")

    on_card = dev.type == "cuda"
    kernel_ms = best_ms(kernel, reps, dev)
    line = {
        "batch": batch, "horizon": N, "n": n,
        "dtype": str(dtype).removeprefix("torch."), "reps": reps,
        "kernel_ms": kernel_ms,
        "kernel_ms_graph": profiling.time_warm(kernel) if on_card else None,
        "general_recursion_ms": best_ms(general, reps, dev),
        "plain_ms": best_ms(plain, reps, dev),
    }
    line["speedup_vs_general"] = line["general_recursion_ms"] / kernel_ms
    line["bound_ms"], line["bound_by"] = riccati.bound_ms(args, dtype)
    line["agreement"] = {
        "scale_max_abs_K": scale,
        "median_rel": float(rel.median()),
        "max_rel": float(rel.max()),
        "kernel_vs_plain_max_abs": kernel_vs_plain,
        "rtol": rtol, "atol": atol, "within_tolerance": within,
    }
    line["launches"] = riccati.LAUNCHES - launches0
    line["device"] = profiling.device_line(dev)
    return line


def main(device=None) -> int:
    batch = int(os.environ.get("ILQG_BENCH_BATCH", "8192"))
    reps = int(os.environ.get("REPS", "50"))
    dev = resolve_device(device)
    for b, dtype in ((batch, torch.float32), (MAIN_BATCH, torch.float64)):
        line = bench_shape(b, dtype, reps, dev)
        a = line["agreement"]
        print(f"# {line['dtype']} B={line['batch']} N={line['horizon']}: "
              f"kernel {line['kernel_ms']:.4f} ms, general recursion "
              f"{line['general_recursion_ms']:.3f} ms (x"
              f"{line['speedup_vs_general']:.1f}), plain "
              f"{line['plain_ms']:.3f} ms, bound {line['bound_ms']:.4f} ms; "
              f"K against the general recursion relative to max|K|="
              f"{a['scale_max_abs_K']:.1f}: median {a['median_rel']:.2e}, "
              f"max {a['max_rel']:.2e}")
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
