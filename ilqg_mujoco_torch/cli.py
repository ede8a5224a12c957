"""Command-line runner of the port, the counterpart of ``run.py``: runs
MPC (or one solve) on one card, reports progress, and writes trajectories,
cost traces and checkpoints to npz for offline replay
(``tools/replay.py`` renders a ``--batch 1`` trajectory file unchanged).

Examples:
  python -m ilqg_mujoco_torch.cli pendulum --frames 100
  python -m ilqg_mujoco_torch.cli pendulum --solve-only --x64
  python -m ilqg_mujoco_torch.cli hopper --frames 200 --out hop.npz
  python -m ilqg_mujoco_torch.cli tumbler --frames 20           # nq != nv
  python -m ilqg_mujoco_torch.cli pendulum --batch 4096 --frames 2
  python -m ilqg_mujoco_torch.cli hopper --frames 50 --checkpoint ck.npz
  python -m ilqg_mujoco_torch.cli hopper --frames 50 --resume ck.npz
  python -m ilqg_mujoco_torch.cli pendulum --device cpu --frames 10
  python -m ilqg_mujoco_torch.cli pendulum --batch 4096 --mesh 4  # 4 cards
  python -m ilqg_mujoco_torch.cli pendulum --batch 8 --mesh 2 --device cpu

The run is on the card; ``--device cpu`` is the only way to run on the
CPU.  ``--batch B > 1`` starts B instances at qpos0 with qpos noise 0.01
drawn from a generator seeded with 0, without warm-in; ``--batch 1`` starts
one warmed-in instance.  ``--resume`` takes its batch size from the file
and continues where the checkpoint left off; a checkpoint counts the
frames run since the start in ``extra/frames``.

``--mesh N`` splits the batch over N ranks, one process per card
(``cuda:0`` to ``cuda:N-1`` over nccl; with ``--device cpu``, N gloo
ranks on the CPU): rank r runs the batched MPC over rows [r B/N,
(r+1) B/N) of the same start.  Rank 0 prints the lines for the whole batch
(env-frames/s over the slowest rank's seconds) and writes ``--out`` and
``--checkpoint`` from the gathered batch, with a one-process run's keys;
``--resume`` splits the file's batch.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from . import ilqr, mpc
from .models import envs
from .kernels import riccati
from .parallel import batch as pbatch
from .parallel import distributed
from .physics.model import resolve_device
from .utils import checkpoint, profiling

NOISE_SEED = 0     # the JAX package's fixed PRNGKey(0)
QPOS_NOISE = 0.01


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ilqg_mujoco_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("env", help="environment name (see models/envs.REGISTRY:"
                                " pendulum|hopper|humanoid|tumbler)")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--mode", choices=["compat", "tassa"], default=None)
    ap.add_argument("--engine", choices=["fd", "ad", "exact"], default=None)
    ap.add_argument("--backward", choices=["scan", "assoc"], default=None,
                    help="Riccati backward executor: sequential scan or "
                         "associative-scan (O(log N) depth) parallel form")
    ap.add_argument("--solve-only", action="store_true",
                    help="run one iLQR solve and print the cost trace")
    ap.add_argument("--batch", type=int, default=None,
                    help="independent instances (default 1, or the "
                         "--resume file's)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="split the batch over N ranks, one process per "
                         "card (gloo ranks on the CPU with --device cpu; "
                         "requires --batch > 1)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="write (env state, solver state) npz after the run")
    ap.add_argument("--resume", type=str, default=None,
                    help="resume from a --checkpoint npz (skips warm-in)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    ap.add_argument("--x64", action="store_true", help="float64 (default "
                                                       "float32)")
    ap.add_argument("--horizon", type=int, default=None,
                    help="override solver horizon N")
    ap.add_argument("--iters", type=int, default=None,
                    help="override iLQR iterations per solve")
    ap.add_argument("--control-limits", action="store_true",
                    help="control-limited iLQG (boxQP backward pass; "
                         "respects actuator ctrlrange)")
    ap.add_argument("--value-scaling", action="store_true",
                    help="overflow-free scaled value recursion (long "
                         "stiff-contact horizons in f32)")
    return ap


def _env(args) -> envs.Env:
    kw = {k: v for k, v in (("mode", args.mode), ("engine", args.engine))
          if v}
    env = envs.make(args.env, **kw)
    over = {k: v for k, v in (("horizon", args.horizon),
                              ("iterations", args.iters),
                              ("backward", args.backward)) if v}
    if args.control_limits:
        over["control_limits"] = True
    if args.value_scaling:
        over["value_scaling"] = True
    if over:
        env = dataclasses.replace(env,
                                  ilqr=dataclasses.replace(env.ilqr, **over))
    return env


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.env not in envs.REGISTRY:
        ap.error(f"unknown env {args.env!r}; available: "
                 f"{', '.join(sorted(envs.REGISTRY))}")
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (--device cpu)")
    dtype = torch.float64 if args.x64 else torch.float32
    try:
        env = _env(args)
    except ValueError as e:          # an ILQRConfig the solver refuses
        ap.error(str(e))
    cfg = env.ilqr
    print(f"env={env.name} mode={cfg.mode} engine={cfg.lin.engine} "
          f"backward={cfg.backward} N={cfg.horizon} iters={cfg.iterations} "
          f"device={_device_name(dev)} dtype={str(dtype).split('.')[-1]}")

    if args.mesh:
        return _run_mesh(ap, args, dev)
    done = 0
    if args.resume:
        x0, sol0, extra = checkpoint.load(args.resume, dev, dtype)
        B = x0.qpos.shape[0]
        if args.batch is not None and args.batch != B:
            ap.error(f"--batch {args.batch} does not match the {B} "
                     f"instance(s) of {args.resume}")
        done = int(extra.get("frames", 0))
        print(f"resumed from {args.resume} (t={float(x0.time[0]):.3f}, "
              f"B={B}, frames so far {done})")
    else:
        B = 1 if args.batch is None else args.batch
        if B < 1:
            ap.error("--batch must be at least 1")
        if B == 1:
            x0, sol0 = mpc.init(env, device=dev, dtype=dtype)
        else:
            gen = torch.Generator().manual_seed(NOISE_SEED)
            x0, sol0 = pbatch.init_batched(env, B, QPOS_NOISE,
                                           generator=gen, device=dev,
                                           dtype=dtype)

    timer = profiling.Timer(dev)
    if args.solve_only:
        for name in ("solve (first)", "solve (steady)"):
            with timer.phase(name) as box:
                _, trace = ilqr.solve(env.model, env.cost_fn, x0, sol0, cfg)
            print(f"{name}: {box['seconds'] * 1e3:.1f} ms (B={B})")
        print("cost trace:", trace.cpu().numpy().squeeze(0) if B == 1
              else trace.cpu().numpy())
        return

    with timer.phase("mpc") as box:
        out = mpc.run(env, args.frames, x0=x0, sol0=sol0)
    _report(args, B, done, box["seconds"], out)


def _report(args, B, done, dt, out: mpc.MPCOut) -> None:
    """Print the run's lines and write ``--checkpoint`` and ``--out``."""
    print(f"{args.frames} MPC frames in {dt:.2f}s (B={B})")
    if B > 1:
        print(f"{args.frames} frames x {B} instances: {dt:.2f}s "
              f"({profiling.throughput(args.frames * B, dt, 'env-frames')})")
        print("mean step cost (last frame):",
              float(out.step_cost[:, -1].mean()))
    else:
        print("final qpos:", out.final_state.qpos[0].cpu().numpy().round(4))
        print("mean step cost:", float(out.step_cost.mean()))
    if args.checkpoint:
        checkpoint.save(args.checkpoint, out.final_state, out.final_sol,
                        extra={"frames": done + args.frames})
        print("checkpointed to", args.checkpoint)
    if args.out:
        np_ = lambda x: x.cpu().numpy()
        if B == 1:
            # run.py's single-instance keys and shapes
            np.savez(args.out, qpos=np_(out.env_states.qpos[0]),
                     qvel=np_(out.env_states.qvel[0]),
                     ctrl=np_(out.controls[0]),
                     cost_trace=np_(out.cost_trace[0]),
                     step_cost=np_(out.step_cost[0]))
        else:
            # run.py's batched keys: final qpos (B, nq), costs (frames, B)
            np.savez(args.out, qpos=np_(out.final_state.qpos),
                     costs=np_(out.step_cost.T))
        print("wrote", args.out)


def _run_mesh(ap, args, dev) -> None:
    """``--mesh N``: check the batch, then run ``_mesh_rank`` on N ranks."""
    if args.mesh < 0:
        ap.error("--mesh takes a number of ranks (0: one process)")
    if args.solve_only:
        ap.error("--mesh runs the batched MPC; it takes no --solve-only")
    if dev.type == "cuda" and dev.index is not None:
        ap.error("--mesh gives rank r the card cuda:r; pass --device cuda")
    B = args.batch
    if args.resume:
        with np.load(args.resume) as z:
            mu = z["sol/mu"]
        n = mu.shape[0] if mu.ndim else 1
        if B is not None and B != n:
            ap.error(f"--batch {B} does not match the {n} instance(s) of "
                     f"{args.resume}")
        B = n
    if B is None or B < 2:
        ap.error("--mesh requires --batch > 1")
    if B % args.mesh:
        ap.error(f"--mesh {args.mesh} does not divide the batch of {B}")
    print(f"mesh: {args.mesh} ranks, {B // args.mesh} instances each, "
          f"{'nccl, one card each' if dev.type == 'cuda' else 'gloo'}")
    distributed.launch(_mesh_rank, args.mesh, args, B,
                       device=None if dev.type == "cuda" else "cpu")


def _mesh_rank(mesh: pbatch.Mesh, args, B: int) -> None:
    """One rank of ``--mesh``: the batched MPC over its block; rank 0
    prints and writes the whole batch's results."""
    env = _env(args)
    dtype = torch.float64 if args.x64 else torch.float32
    done = 0
    if args.resume:
        x0, sol0, extra = checkpoint.load(args.resume, "cpu", dtype)
        t0 = float(x0.time[0])
        x0, sol0 = pbatch.shard_batch((x0, sol0), mesh)
        done = int(extra.get("frames", 0))
        if mesh.rank == 0:
            print(f"resumed from {args.resume} (t={t0:.3f}, B={B}, frames "
                  f"so far {done})")
    else:
        gen = torch.Generator().manual_seed(NOISE_SEED)
        x0, sol0 = pbatch.init_batched(env, B, QPOS_NOISE, generator=gen,
                                       dtype=dtype, mesh=mesh)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    riccati.LAUNCHES = 0
    with profiling.Timer(mesh.device).phase("mpc") as box:
        out = mpc.run(env, args.frames, x0=x0, sol0=sol0)
    peak = torch.cuda.max_memory_allocated(mesh.device) if cuda else 0
    stats = torch.tensor([[box["seconds"], riccati.LAUNCHES, peak / 2 ** 30]],
                         dtype=torch.float64, device=mesh.device)
    stats, final_state, final_sol, step_cost = distributed.gather_batch(
        (stats, out.final_state, out.final_sol, out.step_cost), mesh)
    if mesh.rank != 0:
        return
    n = B // mesh.world
    for r, (sec, launches, gib) in enumerate(stats.tolist()):
        where = _device_name(torch.device("cuda", r)) if cuda else "cpu"
        print(f"rank {r}: {where}, rows [{r * n}, {(r + 1) * n}), "
              f"{sec:.2f}s, {int(launches)} Riccati launches"
              + (f", peak {gib:.2f} GiB" if cuda else ""))
    _report(args, B, done, float(stats[:, 0].max()),
            mpc.MPCOut(None, None, None, step_cost, final_state, final_sol))


if __name__ == "__main__":
    main()
