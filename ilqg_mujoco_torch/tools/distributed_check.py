"""The data-parallel path, run over several ranks and held to one
process: the counterpart of the JAX package's ``tools/distributed_check.py``
and ``__graft_entry__.dryrun_multichip``.

    python -m ilqg_mujoco_torch.tools.distributed_check --nprocs 4
    python -m ilqg_mujoco_torch.tools.distributed_check --nprocs 2 --shared
    python -m ilqg_mujoco_torch.tools.distributed_check --nprocs 2 \\
        --device cpu --batch 8 --horizon 10 --iters 3 --numpy-noise

Each rank (``parallel/distributed.launch``) builds its block of the global
batch (``parallel/batch.init_batched`` with its mesh), runs the sharded
batched solve and ``frames`` MPC frames, takes ``global_mean`` of the last
costs, and gathers the traces, trajectories and gains in rank order.  Each
reports its device, block, solve and frame seconds (``utils/profiling
.Timer``), its Riccati kernel launches (``kernels/riccati.LAUNCHES`` counts
per process) and its peak device memory.  The same function on one process
without a process group is the reference that the gathered batch must
equal: bit for bit where the blocks run the same operations as the whole
batch (the CPU), else within ``GOLDEN_TOLS``, the golden tolerances of
``tests/test_golden_compat.py``.

``--device cpu`` runs the ranks on the CPU over ``gloo``; ``--shared`` puts
every rank on ``cuda:0`` over ``gloo``; the default is one card per rank
over ``nccl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ..kernels import riccati
from ..models import envs
from ..parallel import batch as pbatch
from ..parallel import distributed
from ..utils import profiling

# card against CPU and block against whole batch: {name: (rtol, atol)}
GOLDEN_TOLS = dict(trace=(1e-5, 0.0), ctrl=(1e-4, 1e-7), K=(1e-3, 1e-6),
                   k=(1e-3, 1e-6), qpos=(1e-5, 1e-8), frame_costs=(1e-5, 0.0),
                   frame_qpos=(1e-5, 1e-8))
# global_mean against the mean of the gathered costs: a sum in another order
MEAN_RTOL = 1e-12


@dataclasses.dataclass(frozen=True)
class Config:
    """The solve each rank runs, on the cart-pole compat+fd in float64 (the
    main path): the solver's cut, the global batch and its start (qpos0
    plus ``qpos_noise`` times standard normal draws: numpy's
    ``RandomState(seed)`` with ``numpy_noise``, as the JAX tool draws
    them, else torch's CPU generator seeded with ``seed``, as the bench
    and the CLI draw them)."""
    batch: int = 4096
    horizon: int = None
    iterations: int = None
    frames: int = 1
    qpos_noise: float = 0.01
    seed: int = 0
    numpy_noise: bool = False

    def make_env(self) -> envs.Env:
        env = envs.pendulum("compat", "fd")
        over = {k: v for k, v in (("horizon", self.horizon),
                                  ("iterations", self.iterations)) if v}
        return dataclasses.replace(
            env, ilqr=dataclasses.replace(env.ilqr, **over))

    def start(self, env, mesh):
        """The global batch's start, this rank's block of it."""
        noise = (np.random.RandomState(self.seed).randn(self.batch,
                                                        env.model.nq)
                 if self.numpy_noise else None)
        return pbatch.init_batched(
            env, self.batch, self.qpos_noise, noise=noise,
            generator=torch.Generator().manual_seed(self.seed), mesh=mesh)


def rank_check(mesh: pbatch.Mesh, cfg: Config) -> dict:
    """One rank's part: returns its record, ``global_mean`` of the last
    costs and, on rank 0, the gathered batch as CPU tensors."""
    env = cfg.make_env()
    states, sols = cfg.start(env, mesh)
    solve = pbatch.make_batched_solve(env, mesh)
    step = pbatch.make_batched_mpc_step(env, mesh)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    timer = profiling.Timer(mesh.device)
    riccati.LAUNCHES = 0
    with timer.phase("solve") as solve_box:
        sol, traces = solve(states, sols)
    s, so, costs = states, sol, []
    with timer.phase("frames") as frames_box:
        for _ in range(cfg.frames):
            s, so, c = step(s, so)
            costs.append(c)
    launches = riccati.LAUNCHES
    block = mesh.block(cfg.batch)
    record = dict(
        rank=mesh.rank, world=mesh.world, device=str(mesh.device),
        device_name=(torch.cuda.get_device_name(mesh.device) if cuda
                     else "cpu"),
        block=[block.start, block.stop], solve_s=solve_box["seconds"],
        frames_s=frames_box["seconds"], launches=launches,
        peak_gib=(torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
                  if cuda else None))
    mean_last = distributed.global_mean(traces[:, -1], mesh)
    arrays = dict(trace=traces, qpos=sol.traj.qpos, ctrl=sol.traj.ctrl,
                  K=sol.K, k=sol.k)
    if cfg.frames:
        arrays.update(frame_costs=torch.stack(costs, 1), frame_qpos=s.qpos)
    arrays = distributed.gather_batch(arrays, mesh)
    return dict(record=record, mean_last=float(mean_last),
                arrays=({k: v.cpu() for k, v in arrays.items()}
                        if mesh.rank == 0 else None))


def rank_mean(mesh: pbatch.Mesh, values: torch.Tensor) -> float:
    """``global_mean`` of a global per-instance array, each rank passing
    its block."""
    return float(distributed.global_mean(pbatch.shard_batch(values, mesh),
                                         mesh))


def compare(results: list, reference: dict, tols=None) -> dict:
    """Hold the gathered batch of ``results`` (``rank_check``'s on every
    rank, from ``distributed.launch``) to ``reference``
    (``rank_check``'s on one process, or its ``arrays`` alone): each of the
    reference's arrays gathered, finite, and bitwise equal where ``tols`` is
    None, else within ``tols[name] = (rtol, atol)``; ``global_mean`` equal
    on every rank to the mean of the gathered last costs at
    ``MEAN_RTOL``.  Raises on a mismatch; returns the largest absolute
    error of each array."""
    got, want = results[0]["arrays"], reference["arrays"]
    if set(want) - set(got):
        raise AssertionError(f"gathered {sorted(got)}, want {sorted(want)}")
    errs = {}
    for name in want:
        a, b = got[name].double(), want[name].double()
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite values")
        errs[name] = float((a - b).abs().max())
        if tols is None:
            if not torch.equal(got[name], want[name]):
                raise AssertionError(f"{name}: not bitwise equal (max abs "
                                     f"err {errs[name]:.3e})")
        else:
            rtol, atol = tols[name]
            bad = (a - b).abs() > atol + rtol * b.abs()
            if bool(bad.any()):
                raise AssertionError(f"{name}: {int(bad.sum())} elements out "
                                     f"of tolerance, max abs err "
                                     f"{errs[name]:.3e}")
    mean = float(got["trace"][:, -1].double().mean())
    for r in results:
        if abs(r["mean_last"] - mean) > MEAN_RTOL * abs(mean):
            raise AssertionError(f"rank {r['record']['rank']}: global_mean "
                                 f"{r['mean_last']!r} != {mean!r}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ilqg_mujoco_torch.tools.distributed_check",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu: ranks on the CPU over gloo (default: one "
                         "card per rank over nccl)")
    ap.add_argument("--shared", action="store_true",
                    help="every rank on cuda:0 over gloo")
    ap.add_argument("--batch", type=int, default=Config.batch)
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--frames", type=int, default=Config.frames)
    ap.add_argument("--numpy-noise", action="store_true",
                    help="the JAX tool's start: 0.02 x RandomState(0)")
    args = ap.parse_args(argv)
    if args.shared and args.device:
        ap.error("--shared puts the ranks on cuda:0; it takes no --device")
    cfg = Config(batch=args.batch, horizon=args.horizon,
                 iterations=args.iters, frames=args.frames,
                 numpy_noise=args.numpy_noise,
                 qpos_noise=0.02 if args.numpy_noise else Config.qpos_noise)
    device = "cuda:0" if args.shared else args.device
    results = distributed.launch(rank_check, args.nprocs, cfg, device=device)
    reference = rank_check(pbatch.make_mesh(1, device), cfg)
    on_cpu = results[0]["record"]["device"] == "cpu"
    errs = compare(results, reference, None if on_cpu else GOLDEN_TOLS)
    for r in results:
        print(json.dumps(r["record"]))
    print(json.dumps({"nprocs": args.nprocs, "bitwise": on_cpu,
                      "max_abs_err": errs,
                      "mean_last": results[0]["mean_last"],
                      "reference": reference["record"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
