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
   and 2 closed-loop MPC frames at B=1024 in float64 through the same
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
9. kernels: each CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes (and ragged batches), in float64 and
   float32, timed with CUDA events, beside its memory/compute bound.

The last line of standard output is the JSON device record; the line
before it names the card and its power limit.  TF32 is switched off for
matrix products and cuDNN, so float32 runs in full float32.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from ilqg_mujoco_torch import ilqr  # noqa: E402
from ilqg_mujoco_torch.kernels import _build, riccati  # noqa: E402
from ilqg_mujoco_torch.models import envs  # noqa: E402
from ilqg_mujoco_torch.ops.linearize import linearize_traj  # noqa: E402
from ilqg_mujoco_torch.parallel import batch  # noqa: E402

B = 4096        # the pendulum's batch in bench.py
HOPPER_B = 1024  # the hopper's batch in bench.py
SEED = 0
FRAMES = 1
TASSA_FRAMES = 1
HOPPER_TASSA_FRAMES = 2
HOPPER_COMPAT_FRAMES = 1
CHECK_B = 8
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def phase_build():
    logs, dt = sync_time(_build.build_all)
    print(f"build: {len(logs)} kernel(s) in {dt:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"  {name}: {line.strip()}")


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
                launches=launches, t_solve=t_solve)


def count_cuda_kernels(fn):
    """CUDA kernels that ``fn`` launches, by the profiler: (count, summed
    kernel ms), or None when the profiler records no device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    return len(kern), sum(e.time_range.elapsed_us() for e in kern) / 1e3


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
    N = cfg.horizon
    return (lin.A[:, :N], lin.B[:, :N], lin.gx, lin.gu[:, :N],
            ilqr.knot_gaps(m, traj))


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


def phase_tassa(env, label, B, seed, device, frames):
    """Drive a tassa path at B through the user's entry points; returns
    what the cross-device check needs."""
    gen = torch.Generator().manual_seed(seed)
    solve = batch.make_batched_solve(env)
    mpc_step = batch.make_batched_mpc_step(env)
    torch.cuda.reset_peak_memory_stats()
    riccati.LAUNCHES = 0
    (states, sols), t_init = sync_time(lambda: batch.init_batched(
        env, B, qpos_noise=0.01, generator=gen, device=device,
        dtype=torch.float64))
    (sol, trace), t_solve = sync_time(lambda: solve(states, sols))
    s, so, frame_costs, t_frames = states, sol, [], []
    for _ in range(frames):
        (s, so, c), dt = sync_time(lambda: mpc_step(s, so))
        frame_costs.append(c)
        t_frames.append(dt)
    launches = riccati.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

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
          f"hand-written kernel launches {launches}; peak memory "
          f"{peak:.2f} GiB")

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


def phase_tassa_cross_device(tassa, tols):
    """Instances 0..7 solved iteration by iteration on the card and on the
    CPU: the same alpha at every iteration, and the main path's numbers
    within ``tols``: {name: (rtol, atol, atol as a share of the largest
    |value|)}."""
    env, iters = tassa["env"], tassa["env"].ilqr.iterations
    label = tassa["label"]
    runs = {}
    for where, move in (("card", lambda x: x[:CHECK_B]),
                        ("cpu", lambda x: x[:CHECK_B].cpu())):
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
        close("trace (card 8 vs B)", card["trace"], tassa["trace"][:CHECK_B]),
        close("trace", tassa["trace"][:CHECK_B], cpu["trace"]),
        close("ctrl", sol.traj.ctrl[:CHECK_B], cpu["sol"].traj.ctrl),
        close("K", sol.K[:CHECK_B], cpu["sol"].K),
        close("k", sol.k[:CHECK_B], cpu["sol"].k),
        close("mu", sol.mu[:CHECK_B], cpu["sol"].mu)]
    print(f"{label} cross-device: instances 0..{CHECK_B - 1} iterated on the "
          f"card ({card['seconds']:.1f} s) and on the CPU "
          f"({cpu['seconds']:.1f} s) select the same alphas; max abs err "
          "trace(card 8 vs B)/trace/ctrl/K/k/mu "
          + " ".join(f"{e:.2e}" for e in errs))
    print(f"{label} selected alpha index per iteration (rows: instances; "
          "0 = alpha 0 rebase, i = alphas[i-1]):")
    for row in card["sel"].tolist():
        print("  " + " ".join(f"{x:2d}" for x in row))
    print(f"{label} smallest decision margin (relative): "
          f"{float(card['margin'].min()):.3e}")


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
    for _ in range(HOPPER_COMPAT_FRAMES):
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


def phase_kernels(env, args, launches):
    mu = env.ilqr.mu
    record = dict(name="riccati_compat", route="cuda",
                  source="ilqg_mujoco_torch/csrc/riccati_compat.cu",
                  replaces="ilqg_mujoco_tpu/experimental/pallas_riccati.py:199",
                  launches=launches, library_ms=None)
    per_dtype = {}
    for dt in (torch.float64, torch.float32):
        full = [x.to(dt) for x in args]
        errs = []
        for label, a in (("B", full), ("5", [x[:5] for x in full]),
                         ("B+1", [torch.cat([x, x[:1]]) for x in full])):
            K, k = riccati.backward_compat_batched(*a, mu)
            torch.cuda.synchronize()
            Kr, kr = riccati.backward_compat_batched_ref(*a, mu)
            for name, got, ref in (("K", K, Kr), ("k", k, kr)):
                if dt == torch.float64:
                    rtol, atol = 1e-9, 1e-11
                else:
                    # 20 steps with mu=1000 cancel ~3 of float32's 7 digits
                    rtol, atol = 1e-4, 1e-6 * float(ref.abs().max())
                errs.append(check_close(
                    f"riccati {dt} Bt={a[1].shape[0]} {name}", got, ref,
                    rtol, atol))
        ms = time_cuda(lambda: riccati.backward_compat_batched(*full, mu),
                       200, 10)
        plain_ms = time_cuda(
            lambda: riccati.backward_compat_batched_ref(*full, mu), 100, 3)
        bound_ms, bound_by = riccati_bound_ms(full, dt)
        per_dtype[dt] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"riccati_compat {dt}: Bt={full[1].shape[0]} kernel {ms:.4f} "
              f"ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max abs err {max(errs):.2e} over Bt in "
              f"(B, 5, B+1)")
    record.update(per_dtype[torch.float64], dtype="float64",
                  float32=per_dtype[torch.float32])
    return [record]


def main():
    t_start = time.perf_counter()

    def mark(phase):
        print(f"[{time.perf_counter() - t_start:.1f} s] {phase}", flush=True)

    phase_environment()
    card = card_line()
    print("card:", card)
    phase_build()
    mark("cart-pole compat+fd")
    env = envs.pendulum("compat", "fd")
    main_out = phase_main_path(env, B, SEED, "cuda")
    args = phase_split(env, main_out)
    phase_cross_device(env, main_out)
    mark("cart-pole tassa+ad")
    phase_tassa_cross_device(
        phase_tassa(envs.pendulum("tassa", "ad"), "tassa", B, SEED, "cuda",
                    TASSA_FRAMES), CARTPOLE_TASSA_TOLS)
    mark("hopper tassa+ad")
    phase_tassa_cross_device(
        phase_tassa(envs.make("hopper"), "hopper tassa", HOPPER_B, SEED,
                    "cuda", HOPPER_TASSA_FRAMES), HOPPER_TASSA_TOLS)
    mark("hopper compat+fd")
    phase_hopper_compat(HOPPER_B, SEED, "cuda")
    mark("kernels")
    kernels = phase_kernels(env, args, main_out["launches"])
    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
