"""Weak scaling of the data-parallel solve over the cards of one machine:
the counterpart of the JAX package's ``tools/weak_scaling.py``.

    python -m ilqg_mujoco_torch.tools.weak_scaling
    python -m ilqg_mujoco_torch.tools.weak_scaling --reps 2 --trials 1

Measures the batched cart-pole tassa+ad solve (the JAX tool's env) over
n = 1 .. ``torch.cuda.device_count()`` ranks, one card and one process
each (``parallel/distributed.launch``), two ways:

1. **fixed total batch** (``--total-batch``): the same B instances in one
   process without a process group (``devices`` 0, the unsharded run) and
   split over each n that divides B;
2. **fixed batch per card** (``--per-device-batch`` PB): B = n x PB.

Each rank runs one warm solve and then, per trial, a chain of
max(reps // 2, 1) solves and a chain of ``reps`` solves, every chain timed
by ``utils/profiling.Timer`` (CUDA events) after a barrier.  A chain's time
is the slowest rank's; ``bench.estimate`` turns them into ``iters_per_s``
(B x iterations per second, minima-differenced) and its spread, and
``time_s`` is the shortest ``reps`` chain.  On a machine with one card a
row with two ranks sharing ``cuda:0`` over ``gloo`` follows each curve's
n = 1, marked ``shared``.  One JSON line per measurement, with the JAX
tool's keys plus ``batch``, ``shared``, ``spread`` and ``device`` (the
card's name and power limit).  ``main(device="cpu")`` runs ranks on the
CPU over ``gloo`` for n = 1, 2 instead (a rehearsal: the times are the
CPU's).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.distributed as dist

from ..bench import NOISE_SEED, QPOS_NOISE, estimate
from ..models import envs
from ..parallel import batch as pbatch
from ..parallel import distributed
from ..physics.model import resolve_device
from ..utils import profiling

ENV = ("pendulum", "tassa", "ad")


def _env():
    name, mode, engine = ENV
    return envs.make(name, mode=mode, engine=engine)


def rank_chains(mesh: pbatch.Mesh, batch: int, reps: int,
                trials: int) -> dict:
    """One rank's chain times over its block of a global ``batch``:
    {"halves": [s per trial], "fulls": [s per trial]}."""
    env = _env()
    states, sols = pbatch.init_batched(
        env, batch, QPOS_NOISE,
        generator=torch.Generator().manual_seed(NOISE_SEED), mesh=mesh)
    solve = pbatch.make_batched_solve(env, mesh)
    timer = profiling.Timer(mesh.device)
    with timer.phase("warm"):
        solve(states, sols)

    def chain(n):
        if mesh.world > 1:
            dist.barrier()
        cur = sols
        with timer.phase(f"chain of {n}") as box:
            for _ in range(n):
                cur, _ = solve(states, cur)
        return box["seconds"]

    halves, fulls = [], []
    for _ in range(trials):
        halves.append(chain(max(reps // 2, 1)))
        fulls.append(chain(reps))
    return dict(halves=halves, fulls=fulls)


def measure(n: int, batch: int, reps: int, trials: int, device=None,
            shared: bool = False) -> tuple:
    """The global ``batch`` over ``n`` ranks (0: in this process, without
    a process group); ``shared`` puts the ranks on ``cuda:0``.  Returns
    (rate, spread, shortest full chain in s) over the slowest rank's
    chains."""
    if n == 0:
        runs = [rank_chains(pbatch.make_mesh(1, device), batch, reps,
                            trials)]
    else:
        dev = "cuda:0" if shared else device
        runs = distributed.launch(rank_chains, n, batch, reps, trials,
                                  device=dev)
    halves = [max(r["halves"][t] for r in runs) for t in range(trials)]
    fulls = [max(r["fulls"][t] for r in runs) for t in range(trials)]
    rate, spread = estimate(halves, fulls, batch * _env().ilqr.iterations,
                            reps)
    return rate, spread, min(fulls)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ilqg_mujoco_torch.tools.weak_scaling",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--per-device-batch", type=int, default=256)
    ap.add_argument("--total-batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    line = profiling.device_line(dev)
    cards = dev.type == "cuda"
    count = torch.cuda.device_count() if cards else 2
    ns = list(range(1, count + 1))
    rt = (args.reps, args.trials)
    print(f"# weak scaling, {'/'.join(ENV)}, {count} "
          f"{'card(s)' if cards else 'CPU ranks'}: {line}")

    def shapes(n):
        """(n, shared) for each measurement of a curve."""
        out = [(n, False)]
        if cards and count == 1 and n == 1:
            out.append((2, True))
        return out

    B = args.total_batch
    rate0, spread0, t0 = measure(0, B, *rt, device=device)
    for n, shared in [s for n in ns if B % n == 0 for s in shapes(n)]:
        rate, spread, t = measure(n, B, *rt, device=device, shared=shared)
        print(json.dumps({
            "curve": "fixed_total_B%d" % B, "devices": n, "time_s": t,
            "vs_unsharded": t / t0, "iters_per_s": rate, "batch": B,
            "shared": shared, "spread": spread, "device": line}))
    print(json.dumps({
        "curve": "fixed_total_B%d" % B, "devices": 0, "time_s": t0,
        "vs_unsharded": 1.0, "iters_per_s": rate0, "batch": B,
        "shared": False, "spread": spread0, "device": line}))

    PB = args.per_device_batch
    base = None
    for n, shared in [s for n in ns for s in shapes(n)]:
        rate, spread, t = measure(n, n * PB, *rt, device=device,
                                  shared=shared)
        base = t if base is None else base
        print(json.dumps({
            "curve": "fixed_per_device_PB%d" % PB, "devices": n,
            "batch": n * PB, "time_s": t, "per_device_time_vs_n1": t / base,
            "iters_per_s": rate, "shared": shared, "spread": spread,
            "device": line}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
