#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ilqg_mujoco_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure:

1. environment: versions, the card's name and power limit; exits non-zero
   when no CUDA device is available;
2. build: every CUDA kernel from the sources in the checkout, with the
   compiler's register and spill report;
3. main path: the batched cart-pole compat+FD iLQR solve (10 iterations)
   and 1 closed-loop MPC frame at B=4096 in float64, through the entry
   points a user calls (parallel/batch.py).  Every cost must be finite and
   the Riccati kernel must have been launched once per iteration (20);
   the solve is timed and split into forward pass / linearize / backward;
4. cross-device check: instances 0..7 re-solved on the CPU must match the
   card at the golden tolerances of tests/test_golden_compat.py;
5. tassa path: the batched cart-pole tassa+ad iLQG solve (10 iterations)
   and 1 closed-loop MPC frame at B=4096 in float64, through the same
   entry points.  Every cost must be finite, each instance's cost trace
   monotone non-increasing and the mean cost must fall; the solve is
   timed and one iteration split into linearize_ad / cost quadratics /
   backward recursion / alpha rollout / selection.  This path launches
   no hand-written kernel: the tassa recursion, the AD linearizer and
   boxQP were never Pallas kernels;
6. tassa cross-device check: instances 0..7 solved iteration by
   iteration on the card and on the CPU must select the same alpha at
   every iteration and match the main path's trace, controls, gains and
   mu;
7. hopper tassa+ad: the batched hopper iLQG solve (N=40, 10 iterations)
   and 1 closed-loop MPC frame at B=1024 in float64 through the same
   entry points, with contacts and the Euler integrator.  Every trace must
   be finite and monotone, and the mean cost must fall; the solve is
   timed, one iteration split, its CUDA kernels counted and the peak
   memory read.  Instances 0..7, iterated on the card and on the CPU, must
   select the same alpha at every iteration, with traces and gains within
   1e-9 relative;
8. hopper compat+fd: the batched compat solve with the reference's
   transposed-A quirk (N=40, 10 iterations) and 1 MPC frame at B=1024,
   its split, kernel count, peak memory and the share of instances that
   end finite (compat has no linesearch: a noisy instance may diverge, as
   the reference's would).  Instances 0..7 solved alone (B=8) on the card
   and on the CPU must match at tests/test_golden_hopper.py's tolerances,
   with non-finite values in the same places, and the B=1024 solve must
   match the card's B=8 solve wherever both are finite.  Neither hopper
   path launches a
   hand-written kernel: the hopper has nu = 3 and the Riccati kernel
   takes nu = 1;
9. tumbler tassa+ad: the batched tumbler iLQG solve (a free joint and 2
   hinges, quaternion states: nq 9, nv 8, nu 2; N=20, 8 iterations) and 1
   MPC frame at B=1024, checked and reported as the hopper's tassa path,
   with instances 0..7 iterated on the card and on the CPU;
10. humanoid tassa+ad: the full humanoid (nq 28, nv 27, nu 21, 161 contact
   pairs, 424 constraint rows per state; N=30, 5 iterations, value
   scaling, reg_init 1e-2) at B=16 and 1 MPC frame, the same checks with
   instances 0..1 on the CPU, the share of one rollout step spent in
   ``collide``, and a second solve that must repeat the first bit for bit.
   Neither new path launches the Riccati kernel (nu = 2 and 21);
11. determinism: at B=16 two cart-pole compat solves (trace, trajectory,
   K, k) and two hopper contact steps after 300 steps from rest (qpos,
   qvel, qacc) must be bitwise equal;
12. entry points: the port's CLI (``python -m ilqg_mujoco_torch.cli``,
   run in-process through ``cli.main``) at B=4096 in float64 (2 MPC
   frames, with --checkpoint and --out) and float32 (1 frame), which must
   launch the Riccati kernel frames x iterations times and give finite
   costs, with env-frames/s and the peak memory printed; resume against a
   straight run at B=16 (4 frames, against 2 and 2 resumed), whose
   checkpoints must be bitwise equal; the live loop at B=1 (3 frames, 30
   launches), each frame's seconds against the 16.7 ms of a 60 fps frame;
   ``profiling.Timer`` around a ~50 ms ``torch.cuda._sleep``, which must
   read at least 90% of the host's synchronised clock; and
   ``frames.forward_frame`` on the hopper at B=1024, which must advance
   time by 8 steps and equal 8 ``forward.step`` calls bit for bit;
13. bench and tools: the port's bench
   (``python -m ilqg_mujoco_torch.bench``, run in-process through
   ``bench.main`` with its env knobs) on the
   cart-pole compat+fd at B=4096 in float64, REPS=2 and TRIALS=1 (a warm
   solve and chains of 1 and 2), whose JSON line must parse, with a
   positive value, ``vs_baseline`` equal to value / the C core's rate in
   baselines.json, and (1 + 1 + 2) x 10 Riccati launches;
   ``tools.perf_breakdown`` on the same path at REPS=1, whose ``backward``
   phase runs the kernel (warm-up and one rep each launch it once and the
   10-iteration solve 10 times: 22); and ``tools.humanoid_balance`` at its
   defaults but 2 frames, whose summary must be finite.  Each tool's
   output is printed before the last line;
14. data parallel: the main path's solve and MPC frame at the same B,
   seed and width, split over ranks (``parallel/distributed.launch``, one
   process each, driven through ``tools/distributed_check``): (a)
   ``device_count()`` ranks over nccl, one card each, and (b) 2 ranks
   sharing ``cuda:0`` over gloo.  Every gathered value must be finite, the
   gathered traces, trajectories, gains and frame results must match the
   main path's at the golden tolerances of phase 4, ``global_mean`` of the
   last costs must equal the mean of the gathered ones at rtol 1e-12, and
   every rank must launch the Riccati kernel 20 times; a rank that raises
   or outlives its timeout fails the run.  Each rank's device, block,
   seconds, launches and peak memory are printed, with the whole batch's
   iterations/s.  (c) With two or more cards, a solve on ``cuda:1`` while
   ``cuda:0`` is current must equal the one on ``cuda:0`` bit for bit (the
   CG's graphs are captured on their tensors' card), and
   ``clear_graphs`` must release ``cuda:1``'s cache too; with one card a
   line says so;
15. kernels: each CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes (and ragged batches), in float64 and
   float32.  The Riccati kernel is also held to its plain version on
   seeded inputs for every even n up to riccati.MAX_N at Bt in (5, 257),
   and timed on the main path's inputs with CUDA events: ``ms`` as a loop
   of 200 eager wrapper calls at B=4096 (the host's cost per call
   included), ``ms_graph`` and ``ms_b8`` L2 warm at B=4096 and at B=8
   (launches replayed from a CUDA graph, so the host's launch cost is not
   timed), and ``ms_cold`` L2 cold at B=4096 (a 128 MB buffer written
   before each launch, each launch between its own events), beside its
   memory/compute bound and the plain version's time.  The build phase
   gates the compiler's report: no spills in the float64 kernel at n = 4
   and 8.

Between paths the solver's cache of captured CG graphs is cleared
(``solver.clear_graphs``), with the memory allocated and reserved printed
before and after, and each path prints how many distinct graph shapes it
captured against the cache's bound.  The wall time is printed after every
phase.

The last line of standard output is the JSON device record; the line
before it names the card and its power limit.  TF32 is switched off for
matrix products and cuDNN, so float32 runs in full float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import re
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from ilqg_mujoco_torch import ilqr  # noqa: E402
from ilqg_mujoco_torch.kernels import _build, riccati  # noqa: E402
from ilqg_mujoco_torch.models import envs  # noqa: E402
from ilqg_mujoco_torch.ops.linearize import linearize_traj  # noqa: E402
from ilqg_mujoco_torch.parallel import batch, distributed  # noqa: E402
from ilqg_mujoco_torch.physics import collision, smooth, solver  # noqa: E402
from ilqg_mujoco_torch.physics import forward as fwd  # noqa: E402
from ilqg_mujoco_torch.physics.model import make_state  # noqa: E402
from ilqg_mujoco_torch.utils import profiling  # noqa: E402

B = 4096        # the pendulum's batch in bench.py
HOPPER_B = 1024  # the hopper's batch in bench.py
TUMBLER_B = 1024  # the tumbler's batch in bench.py
HUMANOID_B = 16  # the humanoid's batch in bench.py
DETERMINISM_B = 16
SEED = 0
FRAMES = 1       # closed-loop MPC frames after each path's solve
CHECK_B = 8
# the humanoid's CPU check: the CPU's ad pass carries a per-lane J of
# 424 x 27 float64 over every instance's 31 x 75 lanes
HUMANOID_CHECK_B = 2
# card against CPU: {name: (rtol, atol, atol as a share of the largest
# |value|)}
CARTPOLE_TASSA_TOLS = dict(trace=(1e-9, 0.0, 0.0), ctrl=(1e-6, 1e-9, 0.0),
                           K=(1e-6, 1e-8, 0.0), k=(1e-6, 1e-9, 0.0),
                           mu=(1e-12, 0.0, 0.0))
# the hopper's gates: traces and gains within 1e-9 relative (entries near
# zero within 1e-9 of the largest entry)
HOPPER_TASSA_TOLS = dict(trace=(1e-9, 0.0, 0.0), ctrl=(1e-9, 0.0, 1e-9),
                         K=(1e-9, 0.0, 1e-9), k=(1e-9, 0.0, 1e-9),
                         mu=(1e-12, 0.0, 0.0))
# H100 SXM data-sheet peaks at 700 W: HBM bandwidth, float64 and float32
# rates outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float64: 34e12, torch.float32: 67e12}
# the Riccati kernel's correctness sweep: n = 2 nv, ragged batches, horizon
SWEEP_N = tuple(range(2, riccati.MAX_N + 1, 2))
SWEEP_BT = (5, 257)
SWEEP_HORIZON = 20
NO_SPILL_N = (4, 8)          # float64 instantiations that must not spill
L2_FLUSH_BYTES = 128 * 2 ** 20
DP_TIMEOUT = 300             # seconds for the ranks of one run to end


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_close(name, got, want, rtol, atol, nonfinite=False):
    """Raise unless |got - want| <= atol + rtol |want| everywhere; returns
    the largest absolute error.  With ``nonfinite`` the two may hold
    non-finite values, but in the same places, and only the finite ones
    are compared."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    fin = torch.isfinite(got)
    if not bool(fin.all()) and not nonfinite:
        raise AssertionError(f"{name}: non-finite values")
    if not torch.equal(fin, torch.isfinite(want)):
        raise AssertionError(f"{name}: non-finite values in other places")
    got, want = got[fin], want[fin]
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of "
                             f"tolerance, max abs err {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def phase_environment():
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    print("nvcc:", _build.nvcc_version().strip().splitlines()[-1])
    try:
        import triton
        print("triton", triton.__version__, "(not used)")
    except ImportError:
        print("triton: not installed (not used)")
    print("device:", torch.cuda.get_device_name(0), "count",
          torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cudnn")


def ptxas_report(log):
    """{(dtype name, n): (registers, spill bytes stored + loaded)} for each
    Riccati kernel instantiation in an ``nvcc -Xptxas -v`` log."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"riccati_compat_kernelI([df])Li(\d+)E", m.group(1))
            key = (("float64" if k.group(1) == "d" else "float32"),
                   int(k.group(2))) if k else None
            if key:
                out[key] = [None, 0]
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[key][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_build():
    """Build every kernel; returns the Riccati kernel's registers by dtype
    name and n, and raises if a float64 kernel in NO_SPILL_N spills."""
    logs, dt = sync_time(_build.build_all)
    print(f"build: {len(logs)} kernel(s) in {dt:.1f} s")
    report = ptxas_report(logs["riccati_compat"])
    registers = {}
    for (dt_name, n), (regs, spill) in sorted(report.items()):
        registers.setdefault(dt_name, {})[n] = regs
        print(f"  riccati_compat {dt_name} n={n}: {regs} registers, "
              f"{spill} bytes spilled")
    for n in NO_SPILL_N:
        if ("float64", n) not in report:
            raise AssertionError(f"no ptxas report for the float64 kernel at "
                                 f"n={n}")
        if report[("float64", n)][1]:
            raise AssertionError(f"the float64 kernel spills at n={n}")
    return registers


def phase_main_path(env, B, seed, device):
    """Drive the main path; returns what later phases check."""
    gen = torch.Generator().manual_seed(seed)
    solve = batch.make_batched_solve(env)
    mpc_step = batch.make_batched_mpc_step(env)
    riccati.LAUNCHES = 0
    (states, sols), t_init = sync_time(lambda: batch.init_batched(
        env, B, qpos_noise=0.01, generator=gen, device=device,
        dtype=torch.float64))
    (sol, trace), t_solve = sync_time(lambda: solve(states, sols))
    s, so, frame_costs, t_frames = states, sol, [], []
    for _ in range(FRAMES):
        (s, so, c), dt = sync_time(lambda: mpc_step(s, so))
        frame_costs.append(c)
        t_frames.append(dt)
    launches = riccati.LAUNCHES

    iters = env.ilqr.iterations
    want = iters * (1 + FRAMES)
    if launches != want:
        raise AssertionError(f"Riccati kernel launched {launches} times on "
                             f"the main path, expected {want}")
    costs = torch.cat([trace.flatten()] + frame_costs)
    if not bool(torch.isfinite(costs).all()):
        raise AssertionError("non-finite cost on the main path")
    if not bool(torch.isfinite(so.traj.qpos).all()):
        raise AssertionError("non-finite trajectory after the MPC frames")
    print(f"main path: B={B} init {t_init:.3f} s, solve ({iters} iterations)"
          f" {t_solve:.3f} s, MPC frames "
          + ", ".join(f"{t:.3f}" for t in t_frames) + " s")
    print(f"main path: {B * iters / t_solve:.1f} iLQR iterations/s "
          f"(float64, B={B}); mean cost {float(trace[:, 0].mean()):.6f} -> "
          f"{float(trace[:, -1].mean()):.6f}; Riccati launches {launches}")
    return dict(states=states, sols=sols, sol=sol, trace=trace,
                launches=launches, t_solve=t_solve,
                frame_costs=torch.stack(frame_costs, 1), frame_qpos=s.qpos)


def count_cuda_kernels(fn):
    """CUDA kernels that ``fn`` launches, by the profiler: (count, summed
    kernel ms), or None when the profiler records no device events.  Only
    device activity is recorded, and the raw Kineto events are read
    directly: building the profiler's event tree for the ~600,000 kernels
    of a hopper or humanoid iteration took minutes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    return len(kern), sum(kern) / 1e6


def print_kernel_count(fn):
    """Count the CUDA kernels of one call of ``fn`` and print them."""
    counted, dt = sync_time(lambda: count_cuda_kernels(fn))
    if counted is None:
        print("profiler: CUDA kernels per iteration not measured "
              f"(no device events; profiled iteration {dt:.1f} s)")
    else:
        print(f"profiler: {counted[0]} CUDA kernels per iLQR iteration, "
              f"{counted[1]:.1f} ms of kernel time (profiled iteration "
              f"{dt:.1f} s)")


def phase_split(env, main):
    """One iteration of the solve from the main path's start, phase by
    phase; returns that iteration's linearization for the kernel phase."""
    m, cfg = env.model, env.ilqr
    states, sols = main["states"], main["sols"]
    traj, t_fwd = sync_time(lambda: ilqr.forward_pass(m, states, sols, cfg))
    lin, t_lin = sync_time(lambda: linearize_traj(m, traj, env.cost_fn,
                                                  cfg.lin))
    _, t_bwd = sync_time(lambda: ilqr.backward_compat(m, traj, lin, cfg))
    tot = t_fwd + t_lin + t_bwd
    print(f"split of one iteration: forward_pass {t_fwd * 1e3:.1f} ms "
          f"({100 * t_fwd / tot:.1f}%), linearize {t_lin * 1e3:.1f} ms "
          f"({100 * t_lin / tot:.1f}%), backward (kernel) "
          f"{t_bwd * 1e3:.3f} ms ({100 * t_bwd / tot:.2f}%)")

    print_kernel_count(
        lambda: ilqr.iterate_compat(m, env.cost_fn, states, sols, cfg))
    return kernel_args(env, traj, lin)


def kernel_args(env, traj, lin):
    """The Riccati kernel's inputs in one compat iteration, as
    ``ilqr.backward_compat`` passes them (views of the linearization)."""
    N = env.ilqr.horizon
    return (lin.A[:, :N], lin.B[:, :N], lin.gx, lin.gu[:, :N],
            ilqr.knot_gaps(env.model, traj))


def phase_cross_device(env, main):
    cpu = lambda x: x[:CHECK_B].cpu()
    sols = main["sols"]
    sols_cpu = ilqr.ILQRState(sols.traj.map(cpu), cpu(sols.K), cpu(sols.k),
                              cpu(sols.mu))
    (sol_c, trace_c), dt = sync_time(lambda: batch.make_batched_solve(env)(
        main["states"].map(cpu), sols_cpu))
    sol = main["sol"]
    errs = [
        check_close("trace", main["trace"][:CHECK_B], trace_c, 1e-5, 0.0),
        check_close("ctrl", sol.traj.ctrl[:CHECK_B], sol_c.traj.ctrl,
                    1e-4, 1e-7),
        check_close("K", sol.K[:CHECK_B], sol_c.K, 1e-3, 1e-6),
        check_close("k", sol.k[:CHECK_B], sol_c.k, 1e-3, 1e-6)]
    print(f"cross-device: instances 0..{CHECK_B - 1} on the CPU ({dt:.1f} s)"
          " match the card; max abs err trace/ctrl/K/k "
          + " ".join(f"{e:.2e}" for e in errs))


def tassa_iteration(env, x0, sol, times=None):
    """One ``ilqr.iterate_tassa``, part by part (the same calls in the same
    order).  With ``times`` (a dict) each part runs between two
    synchronisations and its seconds go under its name.  Returns (solver
    state, (B,) cost, (B,) selected index into (0,) + alphas, (B,) margin
    of the acceptance decision relative to the baseline cost)."""
    m, cfg, cost_fn = env.model, env.ilqr, env.cost_fn

    def part(name, fn):
        if times is None:
            return fn()
        out, times[name] = sync_time(fn)
        return out

    lin = part("linearize_ad", lambda: linearize_traj(m, sol.traj, cost_fn,
                                                      cfg.lin))
    quad = part("cost quadratics",
                lambda: ilqr._cost_quadratics(cost_fn, m, sol.traj))
    K, k, _, _, ok = part("backward recursion", lambda: ilqr._tassa_recursion(
        m, lin, quad, sol.traj.ctrl, sol.mu, cfg))
    trajs, costs = part(f"{len(cfg.alphas) + 1}-alpha rollout",
                        lambda: ilqr.linesearch_rollouts(m, cost_fn, x0, sol,
                                                         K, k, cfg))
    new, cost, sel = part("selection", lambda: ilqr.linesearch_select(
        cost_fn, sol, K, k, ok, trajs, costs, cfg))
    # how far the accept/reject and argmin decisions were from a tie
    best = costs[1:].sort(0).values
    margin = torch.minimum((best[0] - costs[0]).abs(),
                           best[1] - best[0]) / costs[0].abs()
    return new, cost, sel, margin


def phase_tassa(env, label, B, seed, device):
    """Drive a tassa path at B through the user's entry points; returns
    what the cross-device check needs."""
    gen = torch.Generator().manual_seed(seed)
    solve = batch.make_batched_solve(env)
    mpc_step = batch.make_batched_mpc_step(env)
    torch.cuda.reset_peak_memory_stats()
    before = riccati.LAUNCHES
    (states, sols), t_init = sync_time(lambda: batch.init_batched(
        env, B, qpos_noise=0.01, generator=gen, device=device,
        dtype=torch.float64))
    (sol, trace), t_solve = sync_time(lambda: solve(states, sols))
    s, so, frame_costs, t_frames = states, sol, [], []
    for _ in range(FRAMES):
        (s, so, c), dt = sync_time(lambda: mpc_step(s, so))
        frame_costs.append(c)
        t_frames.append(dt)
    launches = riccati.LAUNCHES - before
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches:
        raise AssertionError(f"the Riccati kernel launched {launches} times "
                             f"on the {label} path (tassa has its own "
                             "recursion)")

    costs = torch.cat([trace.flatten()] + frame_costs)
    if not bool(torch.isfinite(costs).all()):
        raise AssertionError(f"non-finite cost on the {label} path")
    if not bool(torch.isfinite(so.traj.qpos).all()):
        raise AssertionError(f"non-finite trajectory after the {label} "
                             "frames")
    rise = float(trace.diff(dim=1).max())
    if rise > 1e-9:
        raise AssertionError(f"a {label} cost trace rose by {rise:.3e}")
    cost_init = ilqr._traj_cost(env.cost_fn, sols.traj)
    c0, c1 = float(cost_init.mean()), float(trace[:, -1].mean())
    if not c1 < c0:
        raise AssertionError(f"{label} mean cost did not fall: {c0} -> {c1}")
    iters = env.ilqr.iterations
    print(f"{label} path: B={B} init {t_init:.3f} s, solve ({iters} "
          f"iterations) {t_solve:.3f} s, MPC frames "
          + ", ".join(f"{t:.3f}" for t in t_frames) + " s")
    print(f"{label} path: {B * iters / t_solve:.1f} iLQR iterations/s "
          f"(float64, B={B}); mean cost {c0:.6f} (initial rollout) -> "
          f"{c1:.6f}; largest trace step {rise:.3e}; mu in "
          f"[{float(sol.mu.min()):.3e}, {float(sol.mu.max()):.3e}]; "
          f"Riccati kernel launches {launches}; peak memory {peak:.2f} GiB")

    times = {}
    tassa_iteration(env, states, sols, times)
    tot = sum(times.values())
    print(f"{label} split of one iteration: " + ", ".join(
        f"{name} {t * 1e3:.1f} ms ({100 * t / tot:.1f}%)"
        for name, t in times.items()))
    print_kernel_count(lambda: ilqr.iterate_tassa(
        env.model, env.cost_fn, states, sols, env.ilqr))
    return dict(env=env, label=label, states=states, sols=sols, sol=sol,
                trace=trace)


def phase_tassa_cross_device(tassa, tols, check_b=CHECK_B):
    """Instances 0..check_b-1 solved iteration by iteration on the card
    and on the CPU: the same alpha at every iteration, and the main path's
    numbers within ``tols``: {name: (rtol, atol, atol as a share of the
    largest |value|)}."""
    env, iters = tassa["env"], tassa["env"].ilqr.iterations
    label = tassa["label"]
    runs = {}
    for where, move in (("card", lambda x: x[:check_b]),
                        ("cpu", lambda x: x[:check_b].cpu())):
        s0 = tassa["sols"]
        x0 = tassa["states"].map(move)
        sol = ilqr.ILQRState(s0.traj.map(move), move(s0.K), move(s0.k),
                             move(s0.mu))
        trace, sels, margins = [], [], []
        t0 = time.perf_counter()
        for _ in range(iters):
            sol, cost, sel, margin = tassa_iteration(env, x0, sol)
            trace.append(cost)
            sels.append(sel)
            margins.append(margin)
        runs[where] = dict(sol=sol, trace=torch.stack(trace, 1),
                           sel=torch.stack(sels, 1).cpu(),
                           margin=torch.stack(margins, 1).cpu(),
                           seconds=time.perf_counter() - t0)
    card, cpu = runs["card"], runs["cpu"]
    if not torch.equal(card["sel"], cpu["sel"]):
        raise AssertionError(f"{label}: the card and the CPU selected "
                             f"different alphas:\n{card['sel']}\n"
                             f"{cpu['sel']}")
    sol = tassa["sol"]

    def close(name, got, want):
        rtol, atol, atol_rel = tols[name.split()[0]]
        atol += atol_rel * float(want.detach().abs().max())
        return check_close(f"{label} {name}", got, want, rtol, atol)

    errs = [
        close(f"trace (card {check_b} vs B)", card["trace"],
              tassa["trace"][:check_b]),
        close("trace", tassa["trace"][:check_b], cpu["trace"]),
        close("ctrl", sol.traj.ctrl[:check_b], cpu["sol"].traj.ctrl),
        close("K", sol.K[:check_b], cpu["sol"].K),
        close("k", sol.k[:check_b], cpu["sol"].k),
        close("mu", sol.mu[:check_b], cpu["sol"].mu)]
    print(f"{label} cross-device: instances 0..{check_b - 1} iterated on the "
          f"card ({card['seconds']:.1f} s) and on the CPU "
          f"({cpu['seconds']:.1f} s) select the same alphas; max abs err "
          f"trace(card {check_b} vs B)/trace/ctrl/K/k/mu "
          + " ".join(f"{e:.2e}" for e in errs))
    print(f"{label} selected alpha index per iteration (rows: instances; "
          "0 = alpha 0 rebase, i = alphas[i-1]):")
    for row in card["sel"].tolist():
        print("  " + " ".join(f"{x:2d}" for x in row))
    print(f"{label} smallest decision margin (relative): "
          f"{float(card['margin'].min()):.3e}")


def clear_graph_cache(label):
    """Report the graph cache of the path just run, then clear it: the
    distinct shapes the path captured, the captures (more than the shapes
    when the LRU evicted one), and the memory allocated and reserved
    before and after the clear."""
    g = solver._GRAPHS
    gib = 2 ** 30
    before = (torch.cuda.memory_allocated() / gib,
              torch.cuda.memory_reserved() / gib)
    keys, captures, held = len(g.keys), g.captures, len(g.steps)
    solver.clear_graphs()
    after = (torch.cuda.memory_allocated() / gib,
             torch.cuda.memory_reserved() / gib)
    print(f"{label}: {keys} distinct CG graph shapes, {captures} captures, "
          f"{held} held at the end (bound {g.size}); clear_graphs: memory "
          f"allocated {before[0]:.2f} -> {after[0]:.2f} GiB, reserved "
          f"{before[1]:.2f} -> {after[1]:.2f} GiB")


def collide_share(env, tassa):
    """The share of one rollout step spent in ``collide``: one physics
    step of the linesearch's (len(alphas)+1) x B instances at the first
    knot after the start, against ``collide`` alone on the same geom
    frames, each the median of 5 synchronised calls."""
    m = env.model
    na = len(env.ilqr.alphas) + 1
    x = tassa["sols"].traj.map(
        lambda a: a[:, 1].repeat((na,) + (1,) * (a.dim() - 2)))
    kin = smooth.kinematics(m, x.qpos)

    def median(fn):
        fn()
        return statistics.median(sync_time(fn)[1] for _ in range(5))

    t_step = median(lambda: fwd.step(m, x))
    t_col = median(lambda: collision.collide(m, kin.geom_xpos,
                                             kin.geom_xmat))
    print(f"{tassa['label']}: one rollout step of {x.qpos.shape[0]} "
          f"instances {t_step * 1e3:.2f} ms, collide ({len(m.pair_geom1)} "
          f"pairs) {t_col * 1e3:.2f} ms: {100 * t_col / t_step:.1f}% of "
          "the step")


def same_solves(what, one, two):
    """Raise unless two solves, (solver state, trace) each, have the same
    bits in trace, trajectory, K and k."""
    (s1, t1), (s2, t2) = one, two
    for name, a, b in (("trace", t1, t2), ("qpos", s1.traj.qpos,
                                           s2.traj.qpos),
                       ("ctrl", s1.traj.ctrl, s2.traj.ctrl),
                       ("K", s1.K, s2.K), ("k", s1.k, s2.k)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differ in {name}")


def check_solve_repeats(env, tassa):
    """The path's solve run again on the same inputs must give the same
    bits: trace, trajectory, K and k."""
    (sol, trace), dt = sync_time(lambda: batch.make_batched_solve(env)(
        tassa["states"], tassa["sols"]))
    same_solves(f"{tassa['label']}: two solves", (sol, trace),
                (tassa["sol"], tassa["trace"]))
    print(f"{tassa['label']}: a second solve at B={trace.shape[0]} "
          f"({dt:.1f} s) repeats the first bit for bit (trace, qpos, ctrl, "
          "K, k)")


def phase_humanoid(B, seed, device):
    """The full humanoid's tassa+ad path at B, its checks against the CPU
    on instances 0..1, the share of a rollout step in ``collide``, and a
    second solve that must repeat the first."""
    env = envs.make("humanoid")
    tassa = phase_tassa(env, "humanoid", B, seed, device)
    collide_share(env, tassa)
    check_solve_repeats(env, tassa)
    phase_tassa_cross_device(tassa, HOPPER_TASSA_TOLS, HUMANOID_CHECK_B)


def phase_determinism(B, seed, device):
    """At B: two cart-pole compat solves from the same start, and two
    hopper contact steps from the same state 300 steps after rest, must be
    bitwise equal (the card's counterpart of
    tests/test_torch_determinism.py)."""
    env = envs.pendulum("compat", "fd")
    gen = torch.Generator().manual_seed(seed)
    states, sols = batch.init_batched(env, B, qpos_noise=0.01, generator=gen,
                                      device=device, dtype=torch.float64)
    solve = batch.make_batched_solve(env)
    first, dt = sync_time(lambda: solve(states, sols))
    same_solves("two cart-pole compat solves", first, solve(states, sols))
    m = envs.make("hopper").model
    s = make_state(m, B, device=device)
    for _ in range(300):
        s = fwd.step(m, s)
    a, b = fwd.step(m, s), fwd.step(m, s)
    for name in ("qpos", "qvel", "qacc"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"two hopper contact steps differ in "
                                 f"{name}")
    print(f"determinism: B={B} two cart-pole compat solves ({dt:.1f} s "
          "each) and two hopper contact steps after 300 steps are bitwise "
          "equal")


def phase_entry_points(workdir, B, seed, device):
    """Drive the port's CLI, live loop, Timer and frame helper on the card
    (phase 12); returns the Riccati launches of each kernel-launching
    step."""
    from ilqg_mujoco_torch import cli, live_view
    from ilqg_mujoco_torch.utils import frames
    d = pathlib.Path(workdir)
    env = envs.pendulum("compat", "fd")
    iters = env.ilqr.iterations
    launches = {}

    def cli_run(label, argv, want):
        riccati.LAUNCHES = 0
        cli.main(argv + ["--device", device])
        torch.cuda.synchronize()
        launches[label] = riccati.LAUNCHES
        if riccati.LAUNCHES != want:
            raise AssertionError(f"{label}: the Riccati kernel launched "
                                 f"{riccati.LAUNCHES} times, expected {want}")

    full = ["pendulum", "--mode", "compat", "--engine", "fd", "--batch",
            str(B), "--out", str(d / "out.npz")]
    for dtype, frames_, extra in ((np.float64, 2, ["--x64", "--checkpoint",
                                                   str(d / "ck.npz")]),
                                  (np.float32, 1, [])):
        label = f"cli {np.dtype(dtype).name} B={B}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli_run(label, full + ["--frames", str(frames_)] + extra,
                frames_ * iters)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        costs = np.load(d / "out.npz")["costs"]
        if costs.shape != (frames_, B) or costs.dtype != dtype:
            raise AssertionError(f"{label}: costs {costs.shape} "
                                 f"{costs.dtype}")
        if not np.isfinite(costs).all():
            raise AssertionError(f"{label}: non-finite costs")
        print(f"entry points: {label}, {frames_} frames: "
              f"{launches[label]} Riccati launches, peak memory "
              f"{peak:.2f} GiB, {dt:.1f} s with set-up")

    # resume against a straight run: every array of the checkpoints
    small = ["pendulum", "--batch", "16", "--iters", "2", "--horizon", "8",
             "--x64"]
    ck = {n: str(d / f"{n}.npz") for n in "ABC"}
    cli_run("cli straight B=16", small + ["--frames", "4", "--checkpoint",
                                          ck["A"]], 8)
    cli_run("cli first half B=16", small + ["--frames", "2", "--checkpoint",
                                            ck["B"]], 4)
    cli_run("cli resumed B=16", small + ["--frames", "2", "--resume",
                                         ck["B"], "--checkpoint", ck["C"]], 4)
    za, zc = np.load(ck["A"]), np.load(ck["C"])
    if sorted(za.files) != sorted(zc.files):
        raise AssertionError("resume: the checkpoints hold other arrays")
    diff = {k: float(np.nanmax(np.abs(za[k].astype(np.float64)
                                      - zc[k].astype(np.float64)),
                               initial=0.0))
            for k in za.files if not np.array_equal(za[k], zc[k])}
    if diff:
        worst = max(diff, key=diff.get)
        raise AssertionError(f"resume: 2 + 2 resumed frames differ from 4 "
                             f"straight frames in {sorted(diff)}; largest "
                             f"difference {diff[worst]:.3e} in {worst}")
    print(f"entry points: 2 + 2 resumed frames equal 4 straight frames bit "
          f"for bit at B=16 ({len(za.files)} arrays)")

    # the live loop at B=1, headless
    riccati.LAUNCHES = 0
    hist, seconds = live_view.live_loop("pendulum", frames=3, fps=0.0,
                                        headless=True, device=device)
    torch.cuda.synchronize()
    launches["live loop B=1"] = riccati.LAUNCHES
    if riccati.LAUNCHES != 3 * iters:
        raise AssertionError(f"live loop: {riccati.LAUNCHES} Riccati "
                             f"launches, expected {3 * iters}")
    if hist.shape != (3, env.model.nq) or not np.isfinite(hist).all():
        raise AssertionError(f"live loop: history {hist.shape} not finite")
    frame_budget = 1.0 / 60.0
    print("entry points: live loop at B=1 (compat+fd, N=20, 10 "
          "iterations), frame seconds " + ", ".join(
              f"{t:.3f} ({t / frame_budget:.0f}x the 16.7 ms frame)"
              for t in seconds))

    # Timer: an honest fence around ~50 ms of device time, no host sync
    timer = profiling.Timer(device)
    probe = 10_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    cycles = int(probe * 50.0 / start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.phase("sleep") as box:
        torch.cuda._sleep(cycles)
    t_exit = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if box["seconds"] < 0.9 * wall or t_exit < 0.9 * wall:
        raise AssertionError(f"Timer: read {box['seconds'] * 1e3:.2f} ms and "
                             f"returned after {t_exit * 1e3:.2f} ms of "
                             f"{wall * 1e3:.2f} ms")
    print(f"entry points: Timer read {box['seconds'] * 1e3:.2f} ms and "
          f"returned after {t_exit * 1e3:.2f} ms of the host's "
          f"{wall * 1e3:.2f} ms ({100 * box['seconds'] / wall:.1f}%)")

    # forward_frame on the hopper
    hop = envs.make("hopper")
    m = hop.model
    s = batch.batch_states(hop, HOPPER_B, 0.01,
                           generator=torch.Generator().manual_seed(seed),
                           device=device)
    (got, t_frame) = sync_time(lambda: frames.forward_frame(m, s))
    want = s
    for _ in range(8):
        want = fwd.step(m, want)
    for f in dataclasses.fields(got):
        if not torch.equal(getattr(got, f.name), getattr(want, f.name)):
            raise AssertionError(f"forward_frame differs from 8 steps in "
                                 f"{f.name}")
    adv = float((got.time - s.time - 8 * m.opt.timestep).abs().max())
    if frames.steps_per_frame(m) != 8 or adv > 1e-12:
        raise AssertionError(f"forward_frame: {frames.steps_per_frame(m)} "
                             f"steps, time off by {adv:.3e}")
    print(f"entry points: forward_frame on the hopper at B={HOPPER_B} "
          f"({t_frame:.3f} s) advanced 8 steps, equal to 8 forward.step "
          "calls bit for bit")
    return launches


@contextlib.contextmanager
def env_knobs(knobs):
    """Set the environment variables ``knobs`` for the body, then put the
    environment back as it was."""
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_tool(label, fn, knobs):
    """Run a tool's ``main`` in-process under ``knobs``, with the Riccati
    launch count set to 0 just before; print its standard output with a
    prefix and return (return code, its last line, launches, seconds)."""
    buf = io.StringIO()
    riccati.LAUNCHES = 0
    t0 = time.perf_counter()
    with env_knobs(knobs), contextlib.redirect_stdout(buf):
        rc = fn()
    dt = time.perf_counter() - t0
    launches = riccati.LAUNCHES
    lines = [line for line in buf.getvalue().splitlines() if line.strip()]
    for line in lines:
        print(f"  {label}: {line}")
    return rc, lines[-1], launches, dt


def phase_bench_and_tools(workdir, B, device):
    """Drive the port's bench and both tools on the card (phase 13);
    returns the Riccati launches of the bench and of perf_breakdown."""
    from ilqg_mujoco_torch import bench
    from ilqg_mujoco_torch.tools import humanoid_balance, perf_breakdown
    iters = envs.pendulum("compat", "fd").ilqr.iterations
    path = {"ILQG_BENCH_ENV": "pendulum", "ILQG_BENCH_MODE": "compat",
            "ILQG_BENCH_ENGINE": "fd", "ILQG_BENCH_BATCH": str(B)}
    reps, trials = 2, 1
    rc, last, bench_launches, dt = run_tool(
        "bench", lambda: bench.main(device),
        dict(path, ILQG_BENCH_REPS=str(reps), ILQG_BENCH_TRIALS=str(trials),
             ILQG_BENCH_DTYPE="float64"))
    line = json.loads(last)
    ref = json.loads((pathlib.Path(__file__).resolve().parent
                      / "baselines.json").read_text())["pendulum"]
    want_vs = line["value"] / ref["ilqr_iters_per_s"]
    if rc != 0 or not line["value"] > 0:
        raise AssertionError(f"bench: rc {rc}, line {last}")
    # vs_baseline is the unrounded rate's ratio, rounded to 0.01
    if abs(line["vs_baseline"] - want_vs) > 0.0051:
        raise AssertionError(f"bench: vs_baseline {line['vs_baseline']} is "
                             f"not value / {ref['ilqr_iters_per_s']:.2f} = "
                             f"{want_vs:.4f}")
    want = iters * (1 + trials * (max(reps // 2, 1) + reps))
    if bench_launches != want:
        raise AssertionError(f"bench: {bench_launches} Riccati launches, "
                             f"expected {want}")
    print(f"bench and tools: bench line {last}")
    print(f"bench and tools: bench ran {dt:.1f} s with set-up, "
          f"{bench_launches} Riccati launches")

    rc, last, pb_launches, dt = run_tool(
        "perf_breakdown", lambda: perf_breakdown.main(device),
        dict(path, ILQG_BENCH_REPS="1"))
    json.loads(last)                # the line must parse
    want = 2 * (1 + iters)
    if rc != 0:
        raise AssertionError(f"perf_breakdown: rc {rc}")
    if pb_launches != want:
        raise AssertionError(f"perf_breakdown: {pb_launches} Riccati "
                             f"launches, expected {want} (its backward "
                             "phase must run the kernel)")
    print(f"bench and tools: perf_breakdown line {last}")
    print(f"bench and tools: perf_breakdown ran {dt:.1f} s with set-up, "
          f"{pb_launches} Riccati launches")

    out = pathlib.Path(workdir) / "humanoid_balance.npz"
    frames_ = 2
    rc, last, _, dt = run_tool(
        "humanoid_balance",
        lambda: humanoid_balance.main([str(out)], device),
        {"ILQG_HUM_FRAMES": str(frames_)})
    written = pathlib.Path(last.removeprefix("wrote "))
    z = np.load(written)
    summary = json.loads(str(z["summary"]))
    numbers = [v for v in summary.values() if isinstance(v, (int, float))]
    if (summary["frames"] != frames_ or not summary["finite"]
            or not np.isfinite(numbers).all()
            or not all(np.isfinite(z[k]).all() for k in z.files
                       if k != "summary")):
        raise AssertionError(f"humanoid_balance: {written.name}, summary "
                             f"{summary}")
    print(f"bench and tools: humanoid_balance wrote {written.name}, "
          f"{frames_} finite frames in {dt:.1f} s with set-up "
          f"({summary['wall_seconds']} s by the tool), balanced "
          f"{summary['balanced']}")
    return dict(bench=bench_launches, perf_breakdown=pb_launches)


def data_parallel_run(label, nprocs, cfg, device, main):
    """``tools/distributed_check``'s solve on ``nprocs`` ranks, held to the
    main path; returns each rank's Riccati launches."""
    from ilqg_mujoco_torch.tools import distributed_check as dc
    results, dt = sync_time(lambda: distributed.launch(
        dc.rank_check, nprocs, cfg, device=device, timeout=DP_TIMEOUT))
    sol = main["sol"]
    reference = dict(arrays={k: v.cpu() for k, v in (
        ("trace", main["trace"]), ("qpos", sol.traj.qpos),
        ("ctrl", sol.traj.ctrl), ("K", sol.K), ("k", sol.k),
        ("frame_costs", main["frame_costs"]),
        ("frame_qpos", main["frame_qpos"]))})
    errs = dc.compare(results, reference, dc.GOLDEN_TOLS)
    iters = envs.pendulum("compat", "fd").ilqr.iterations
    want = iters * (1 + cfg.frames)
    records = [r["record"] for r in results]
    for r in records:
        print(f"data parallel {label}: rank {r['rank']} of {r['world']} on "
              f"{r['device']} ({r['device_name']}), rows [{r['block'][0]}, "
              f"{r['block'][1]}), solve "
              f"{r['solve_s']:.3f} s, MPC frame {r['frames_s']:.3f} s, "
              f"{r['launches']} Riccati launches, peak {r['peak_gib']:.2f} "
              "GiB")
        if r["launches"] != want:
            raise AssertionError(f"{label}: rank {r['rank']} launched the "
                                 f"Riccati kernel {r['launches']} times, "
                                 f"expected {want}")
    main_mean = float(main["trace"][:, -1].mean())
    mean = results[0]["mean_last"]
    slowest = max(r["solve_s"] for r in records)
    print(f"data parallel {label}: {cfg.batch * iters / slowest:.1f} iLQR "
          f"iterations/s over the whole batch (B={cfg.batch}, slowest rank's "
          f"solve {slowest:.3f} s; main path {main['t_solve']:.3f} s); "
          f"{dt:.1f} s with start-up; global_mean of the last costs "
          f"{mean:.12f} (main path's mean {main_mean:.12f}, relative "
          f"difference {abs(mean - main_mean) / abs(main_mean):.2e}); max abs "
          "err against the main path " + ", ".join(
              f"{k} {e:.2e}" for k, e in errs.items()))
    return [r["launches"] for r in records]


def check_graphs_on_second_card(env, B, seed):
    """A solve on cuda:1 while cuda:0 is current must give the bits of the
    same solve on cuda:0, and ``clear_graphs`` must empty cuda:1's cache."""
    solves = {}
    for dev in ("cuda:0", "cuda:1"):
        gen = torch.Generator().manual_seed(seed)
        states, sols = batch.init_batched(env, B, qpos_noise=0.01,
                                          generator=gen, device=dev)
        solves[dev] = batch.make_batched_solve(env)(states, sols)
    torch.cuda.synchronize("cuda:1")
    if solves["cuda:1"][1].device != torch.device("cuda:1"):
        raise AssertionError("the cuda:1 solve left its card")
    same_solves("solves on cuda:0 and cuda:1", *[
        batch.tree_map(lambda t: t.cpu(), solves[d])
        for d in ("cuda:0", "cuda:1")])
    gib = 2 ** 30
    before = torch.cuda.memory_reserved("cuda:1") / gib
    del solves
    solver.clear_graphs()
    after = torch.cuda.memory_reserved("cuda:1") / gib
    current = torch.cuda.current_device()
    print(f"data parallel: a B={B} solve on cuda:1 (cuda:{current} current)"
          " equals the one on cuda:0 bit for bit "
          f"(trace, qpos, ctrl, K, k); clear_graphs: cuda:1 reserved "
          f"{before:.2f} -> {after:.2f} GiB")
    if not after < before:
        raise AssertionError("clear_graphs left cuda:1's cache as it was")


def phase_data_parallel(main, B, seed):
    """Phase 14: the main path split over ranks; returns each run's
    per-rank Riccati launches."""
    from ilqg_mujoco_torch.tools import distributed_check as dc
    cfg = dc.Config(batch=B, frames=FRAMES, seed=seed)
    n = torch.cuda.device_count()
    launches = {
        f"nccl x{n}": data_parallel_run(f"(a) {n} rank(s), nccl, one card "
                                        "each", n, cfg, None, main),
        "gloo x2 on cuda:0": data_parallel_run(
            "(b) 2 ranks sharing cuda:0, gloo", 2, cfg, "cuda:0", main)}
    if n >= 2:
        check_graphs_on_second_card(envs.pendulum("compat", "fd"),
                                    DETERMINISM_B, seed)
    else:
        print("data parallel: one card, so (a) ran one rank without a "
              "process group, and the check of a solve on a second card "
              "(the CG's graphs on their tensors' card) did not run")
    return launches


def hopper_compat_env():
    """The hopper golden configuration: compat+fd with the reference's
    transposed-A quirk (tests/test_golden_hopper.py)."""
    env = envs.make("hopper", mode="compat", engine="fd")
    lin = dataclasses.replace(env.ilqr.lin, compat_transpose_A=True)
    return dataclasses.replace(
        env, ilqr=dataclasses.replace(env.ilqr, lin=lin))


def phase_hopper_compat(B, seed, device):
    """Drive the hopper compat+fd path at B through the user's entry
    points, split one iteration and check instances 0..7 on the CPU."""
    env = hopper_compat_env()
    m, cfg = env.model, env.ilqr
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    riccati.LAUNCHES = 0
    (states, sols), t_init = sync_time(lambda: batch.init_batched(
        env, B, qpos_noise=0.01, generator=gen, device=device,
        dtype=torch.float64))
    (sol, trace), t_solve = sync_time(
        lambda: batch.make_batched_solve(env)(states, sols))
    mpc_step = batch.make_batched_mpc_step(env)
    s, so, t_frames, frame_costs = states, sol, [], []
    for _ in range(FRAMES):
        (s, so, c), dt = sync_time(lambda: mpc_step(s, so))
        t_frames.append(dt)
        frame_costs.append(c)
    launches = riccati.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches:
        raise AssertionError(f"the Riccati kernel launched {launches} times "
                             "on the hopper (nu = 3)")
    finite = (torch.isfinite(trace).all(1)
              & torch.isfinite(sol.traj.qpos).flatten(1).all(1))
    share = float(finite.double().mean())
    if share == 0.0:
        raise AssertionError("no hopper compat instance ended finite")
    iters = cfg.iterations
    tr = trace[finite]
    print(f"hopper compat path: B={B} init {t_init:.3f} s, solve ({iters} "
          f"iterations) {t_solve:.3f} s, MPC frames "
          + ", ".join(f"{t:.3f}" for t in t_frames) + " s")
    print(f"hopper compat path: {B * iters / t_solve:.1f} iLQR iterations/s "
          f"(float64, B={B}); {int(finite.sum())} of {B} instances "
          f"({100 * share:.1f}%) end finite; their mean cost "
          f"{float(tr[:, 0].mean()):.6f} -> {float(tr[:, -1].mean()):.6f}; "
          f"finite MPC frame costs {int(torch.isfinite(frame_costs[0]).sum())}"
          f" of {B}; Riccati launches {launches}; peak memory {peak:.2f} GiB")

    traj, t_fwd = sync_time(lambda: ilqr.forward_pass(m, states, sols, cfg))
    lin, t_lin = sync_time(lambda: linearize_traj(m, traj, env.cost_fn,
                                                  cfg.lin))
    _, t_bwd = sync_time(lambda: ilqr.backward_compat(m, traj, lin, cfg))
    tot = t_fwd + t_lin + t_bwd
    print(f"hopper compat split of one iteration: forward_pass "
          f"{t_fwd * 1e3:.1f} ms ({100 * t_fwd / tot:.1f}%), linearize "
          f"{t_lin * 1e3:.1f} ms ({100 * t_lin / tot:.1f}%), backward "
          f"(torch backward_pass_compat) {t_bwd * 1e3:.1f} ms "
          f"({100 * t_bwd / tot:.1f}%)")
    print_kernel_count(
        lambda: ilqr.iterate_compat(m, env.cost_fn, states, sols, cfg))

    # instances 0..7 solved alone on each device: the same inputs and the
    # same batch, so the same operations
    runs = {}
    for where, move in (("card", lambda x: x[:CHECK_B]),
                        ("cpu", lambda x: x[:CHECK_B].cpu())):
        runs[where] = sync_time(lambda: batch.make_batched_solve(env)(
            states.map(move), ilqr.ILQRState(sols.traj.map(move),
                                             move(sols.K), move(sols.k),
                                             move(sols.mu))))
    ((sol_g, trace_g), dt_g), ((sol_c, trace_c), dt_c) = (runs["card"],
                                                          runs["cpu"])
    errs = [
        check_close("hopper compat trace", trace_g, trace_c, 1e-4, 0.0,
                    nonfinite=True),
        check_close("hopper compat ctrl", sol_g.traj.ctrl, sol_c.traj.ctrl,
                    1e-3, 1e-5, nonfinite=True),
        check_close("hopper compat qpos", sol_g.traj.qpos, sol_c.traj.qpos,
                    1e-4, 1e-6, nonfinite=True)]
    print(f"hopper compat cross-device: instances 0..{CHECK_B - 1} "
          f"({int(torch.isfinite(trace_c).all(1).sum())} finite) solved on "
          f"the card ({dt_g:.1f} s) and on the CPU ({dt_c:.1f} s) match, "
          "non-finite values in the same places; max abs err trace/ctrl/qpos "
          + " ".join(f"{e:.2e}" for e in errs))
    # the B=1024 solve against the card's solve of the same 8 instances:
    # compat diverges in most instances, and the iteration at which one
    # turns non-finite can hang on the last bit, which kernels chosen for
    # another batch size round differently.  Values are held where both
    # are finite; the entries finite in one only are counted.
    fin_b, fin_g = torch.isfinite(trace[:CHECK_B]), torch.isfinite(trace_g)
    both = fin_b & fin_g
    err = check_close("hopper compat trace (B vs 8)", trace[:CHECK_B][both],
                      trace_g[both], 1e-4, 0.0)
    print(f"hopper compat B={trace.shape[0]} against B={CHECK_B} on the card:"
          f" {int(both.sum())} trace entries finite in both, max abs err "
          f"{err:.2e}; {int((fin_b != fin_g).sum())} entries finite in one "
          "only")


def time_cuda(fn, reps, warmup):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture(fn, calls):
    """A CUDA graph of ``calls`` calls of ``fn`` (warmed on a side stream
    first, as torch.cuda.graphs asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def time_warm(fn, calls=50, replays=10):
    """Device ms per call of ``fn``, its inputs warm in L2: ``calls`` calls
    captured in one CUDA graph, replayed ``replays`` times between two
    events, so the host's launch cost is not timed."""
    graph = capture(fn, calls)
    graph.replay()
    return time_cuda(graph.replay, replays, 1) / calls


def time_cold(fn, reps=30):
    """Median device ms of one call of ``fn`` with L2 cold: before each call
    a 128 MB buffer (over twice the 50 MB L2) is written, and each call,
    replayed from a one-call CUDA graph, lies between its own events.  The
    write keeps the card busy while the host enqueues the call."""
    graph = capture(fn, 1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    events = []
    for _ in range(reps):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def riccati_bound_ms(args, dtype):
    """Least time for the work on an H100 SXM: each input read once, each
    output written once, over the HBM rate; the recursion's arithmetic
    (4n^3 + 15n^2 + 14n + 10 operations per instance and step) over the
    dtype's peak.  Returns (ms, 'bytes' | 'operations')."""
    A, B = args[0], args[1]
    Bt, N, n = B.shape[0], B.shape[1], B.shape[2]
    elems = sum(x.numel() for x in args) + Bt * N * n + Bt * N  # + K, k
    item = torch.finfo(dtype).bits // 8
    t_bytes = elems * item / PEAK_BYTES_S
    t_ops = Bt * N * (4 * n ** 3 + 15 * n ** 2 + 14 * n + 10) / \
        PEAK_FLOP_S[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def random_riccati_args(Bt, N, n, seed, device):
    """Seeded inputs for the Riccati kernel at any n (no nu = 1 model but
    the cart-pole exists to draw them from): A = I + 0.05 randn, B small,
    |r| >= 0.1, float64."""
    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.05 * rng.standard_normal((Bt, N, n, n))
    B = 0.1 * rng.standard_normal((Bt, N, n, 1))
    gx = rng.standard_normal((Bt, N + 1, n))
    r = rng.standard_normal((Bt, N, 1))
    gu = np.sign(r) * (0.1 + np.abs(r))
    diffs = 0.01 * rng.standard_normal((Bt, N, n))
    return [torch.tensor(x, device=device) for x in (A, B, gx, gu, diffs)]


def riccati_tols(dtype, n, ref):
    """(rtol, atol) of the kernel against its plain version.  float64:
    tests/test_pallas_riccati.py's.  float32: 20 steps with mu=1000 cancel
    about 3 of float32's 7 digits (rtol 1e-4, atol 1e-6 max|ref|); each
    step's products sum n terms, and the plain version in float32 strayed
    from float64 by up to 1.3e-7 max|ref| at n=2 and 7.4e-7 at n=32 on
    random_riccati_args (a CPU run), so above n = 8 atol grows as n / 8."""
    if dtype == torch.float64:
        return 1e-9, 1e-11
    return 1e-4, 1e-6 * float(ref.abs().max()) * max(1.0, n / 8)


def check_riccati(args, mu, label):
    """The kernel against its plain version on ``args``; returns the
    largest absolute error of K and k."""
    dt, n = args[0].dtype, args[1].shape[2]
    K, k = riccati.backward_compat_batched(*args, mu)
    torch.cuda.synchronize()
    Kr, kr = riccati.backward_compat_batched_ref(*args, mu)
    return max(check_close(f"riccati {label} {dt} n={n} Bt={args[1].shape[0]}"
                           f" {name}", got, ref, *riccati_tols(dt, n, ref))
               for name, got, ref in (("K", K, Kr), ("k", k, kr)))


def phase_kernels(env, args, launches, registers):
    mu = env.ilqr.mu
    record = dict(name="riccati_compat", route="cuda",
                  source="ilqg_mujoco_torch/csrc/riccati_compat.cu",
                  replaces="ilqg_mujoco_tpu/experimental/pallas_riccati.py:199",
                  launches=launches, library_ms=None,
                  n_checked=list(SWEEP_N), registers=registers)
    per_dtype = {}
    for dt in (torch.float64, torch.float32):
        full = [x.to(dt) for x in args]
        errs = [check_riccati(a, mu, "cart-pole") for a in (
            full, [x[:5] for x in full],
            [torch.cat([x, x[:1]]) for x in full])]
        sweep = {}
        for n in SWEEP_N:
            sweep[n] = max(check_riccati(
                [x.to(dt) for x in random_riccati_args(
                    Bt, SWEEP_HORIZON, n, SEED + n, "cuda")], mu, "random")
                for Bt in SWEEP_BT)
        b8 = [x[:CHECK_B] for x in full]
        launch = lambda a: lambda: riccati.backward_compat_batched(*a, mu)
        ms = time_cuda(launch(full), 200, 10)
        ms_graph = time_warm(launch(full))
        ms_cold = time_cold(launch(full))
        ms_b8 = time_warm(launch(b8))
        plain_ms = time_cuda(
            lambda: riccati.backward_compat_batched_ref(*full, mu), 100, 3)
        plain_ms_b8 = time_cuda(
            lambda: riccati.backward_compat_batched_ref(*b8, mu), 20, 2)
        bound_ms, bound_by = riccati_bound_ms(full, dt)
        bound_ms_b8, _ = riccati_bound_ms(b8, dt)
        per_dtype[dt] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             ms_graph=ms_graph, ms_cold=ms_cold, ms_b8=ms_b8,
                             plain_ms_b8=plain_ms_b8, bound_ms_b8=bound_ms_b8,
                             sweep_max_abs_err=sweep)
        B = full[1].shape[0]
        print(f"riccati_compat {dt}: B={B} eager {ms:.4f} ms, L2 warm "
              f"(graph) {ms_graph:.4f} ms, L2 cold {ms_cold:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms; "
              f"B={CHECK_B} warm (graph) {ms_b8:.4f} ms, bound "
              f"{bound_ms_b8:.6f} ms, plain {plain_ms_b8:.3f} ms; max abs err "
              f"{max(errs):.2e} over Bt in (B, 5, B+1)")
        print(f"riccati_compat {dt}: random inputs, N={SWEEP_HORIZON}, Bt in "
              f"{SWEEP_BT}, max abs err by n: " + ", ".join(
                  f"{n}: {e:.2e}" for n, e in sweep.items()))
    record.update(per_dtype[torch.float64], dtype="float64",
                  float32=per_dtype[torch.float32])
    return [record]


def main():
    t_start = time.perf_counter()

    def mark(phase):
        print(f"[{time.perf_counter() - t_start:.1f} s] {phase}", flush=True)

    phase_environment()
    card = profiling.device_line("cuda")
    print("card:", card)
    registers = phase_build()
    mark("cart-pole compat+fd")
    env = envs.pendulum("compat", "fd")
    main_out = phase_main_path(env, B, SEED, "cuda")
    args = phase_split(env, main_out)
    phase_cross_device(env, main_out)
    clear_graph_cache("cart-pole compat+fd")
    mark("cart-pole tassa+ad")
    phase_tassa_cross_device(
        phase_tassa(envs.pendulum("tassa", "ad"), "tassa", B, SEED, "cuda"),
        CARTPOLE_TASSA_TOLS)
    clear_graph_cache("cart-pole tassa+ad")
    mark("hopper tassa+ad")
    phase_tassa_cross_device(
        phase_tassa(envs.make("hopper"), "hopper tassa", HOPPER_B, SEED,
                    "cuda"), HOPPER_TASSA_TOLS)
    clear_graph_cache("hopper tassa+ad")
    mark("hopper compat+fd")
    phase_hopper_compat(HOPPER_B, SEED, "cuda")
    clear_graph_cache("hopper compat+fd")
    mark("tumbler tassa+ad")
    riccati.LAUNCHES = 0
    phase_tassa_cross_device(
        phase_tassa(envs.make("tumbler"), "tumbler", TUMBLER_B, SEED, "cuda"),
        HOPPER_TASSA_TOLS)
    clear_graph_cache("tumbler tassa+ad")
    mark("humanoid tassa+ad")
    phase_humanoid(HUMANOID_B, SEED, "cuda")
    if riccati.LAUNCHES:
        raise AssertionError(f"the Riccati kernel launched {riccati.LAUNCHES}"
                             " times during the tumbler and humanoid phases")
    print("tumbler and humanoid phases: 0 Riccati kernel launches")
    clear_graph_cache("humanoid tassa+ad")
    mark("determinism")
    phase_determinism(DETERMINISM_B, SEED, "cuda")
    clear_graph_cache("determinism")
    mark("entry points")
    with tempfile.TemporaryDirectory() as workdir:
        entry_launches = phase_entry_points(workdir, B, SEED, "cuda")
    clear_graph_cache("entry points")
    mark("bench and tools")
    with tempfile.TemporaryDirectory() as workdir:
        bench_launches = phase_bench_and_tools(workdir, B, "cuda")
    clear_graph_cache("bench and tools")
    mark("data parallel")
    dp_launches = phase_data_parallel(main_out, B, SEED)
    clear_graph_cache("data parallel")
    mark("kernels")
    kernels = phase_kernels(env, args, main_out["launches"], registers)
    kernels[0]["entry_point_launches"] = entry_launches
    kernels[0]["bench_launches"] = bench_launches
    kernels[0]["data_parallel_launches"] = dp_launches
    mark("done")
    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
