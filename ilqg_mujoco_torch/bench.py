"""Benchmark: batched iLQR throughput on one card, the port's counterpart
of the JAX package's ``bench.py``.

    python -m ilqg_mujoco_torch.bench
    ILQG_BENCH_MODE=compat ILQG_BENCH_ENGINE=fd \\
        python -m ilqg_mujoco_torch.bench

Prints one JSON line, the last on stdout, with ``bench.py``'s keys less
``chunk_knots``, plus ``device`` (the card's name and power limit) and
``dtype``:

  {"metric": "ilqr_iters_per_s_{env}_batch{B}[_{mode}_{engine}]",
   "value": ..., "unit": "iLQR iterations/s/chip", "vs_baseline": ...,
   "spread": {...}, "batch": B, "device": "...", "dtype": "float64"}

``value`` is iLQR iterations per second over a batch of B independent
instances; ``vs_baseline`` divides it by the reference algorithm's rate on
the MuJoCo C core in ``baselines.json`` at the checkout's root, and is null
where that file has no entry for the env.  The peak device memory, and in
compat mode the share of instances whose first solve ends finite (compat
has no linesearch, so an instance may diverge), go to stderr.

Env knobs, with ``bench.py``'s defaults: ILQG_BENCH_ENV
(pendulum|hopper|humanoid|tumbler; pendulum), ILQG_BENCH_MODE
(tassa|compat; tassa), ILQG_BENCH_ENGINE (ad|fd|exact; ad),
ILQG_BENCH_BATCH (``DEFAULT_BATCH``), ILQG_BENCH_REPS (4),
ILQG_BENCH_TRIALS (3), ILQG_BENCH_BACKOFF (1), and ILQG_BENCH_DTYPE
(float64|float32; float64, the precision of the C-core baseline: the
counterpart of running ``bench.py`` with or without ``jax_enable_x64``).

Method (``bench.py``'s): after one warm call, each trial times a chain of
``max(reps // 2, 1)`` solves and a chain of ``reps`` solves, each call
consuming the previous call's solver state.  A chain is timed by
``utils/profiling.Timer``: two CUDA events, with a synchronisation on the
end event.  The headline is :func:`estimate`'s minima-differenced rate,
work / (min over trials of the long chain - min of the short one), which
cancels any fixed cost per chain and takes each chain length's least
disturbed run; the per-trial rates give the spread.

Initial states: qpos0 plus 0.01 times standard normal draws from torch's
CPU generator seeded with 0 (``parallel/batch.py``).  The JAX bench draws
from ``jax.random.PRNGKey(0)``, so the two benches start from different
instances.

Backoff: a CUDA out-of-memory error at batch B drops the solver's captured
CG graphs (``physics/solver.clear_graphs``) and retries at B/2, down to
``MIN_BATCH``; the line then lists the failures under ``backoff_from``.
Any other error propagates.  If no batch fits, the line has value 0 and
``errors``, and the exit code is 1.  ``main`` runs on the card; only a
caller passing ``device="cpu"`` runs it on the CPU.
"""

from __future__ import annotations

import gc
import json
import os
import pathlib
import sys

import torch

from .models import envs
from .parallel import batch as pbatch
from .physics import solver
from .physics.model import resolve_device
from .utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
# bench.py's per-env batches and the floor of its backoff
DEFAULT_BATCH = {"pendulum": 4096, "hopper": 1024, "humanoid": 16,
                 "tumbler": 1024}
MIN_BATCH = {"pendulum": 256, "hopper": 64, "humanoid": 4, "tumbler": 64}
NOISE_SEED = 0
QPOS_NOISE = 0.01
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def build(env_name, mode, engine, batch, dtype, device):
    """The env, B initial states and solver states, and the batched
    solve."""
    env = envs.make(env_name, mode=mode, engine=engine)
    gen = torch.Generator().manual_seed(NOISE_SEED)
    states, sols = pbatch.init_batched(env, batch, qpos_noise=QPOS_NOISE,
                                       generator=gen, device=device,
                                       dtype=dtype)
    return env, states, sols, pbatch.make_batched_solve(env)


def estimate(t_halves, t_fulls, work_per_call, reps):
    """``bench.py``'s estimator on the chain times of each trial: the rate
    from the difference of the minima (the long chain's alone where noise
    swamped the difference, which under-reports), and the sorted per-trial
    rates as the spread.  Returns (rate, spread)."""
    half = max(reps // 2, 1)
    diff = min(t_fulls) - min(t_halves)
    if diff > 0:
        rate = work_per_call * (reps - half) / diff
    else:
        rate = work_per_call * reps / min(t_fulls)
    per_trial = []
    for th, tf in zip(t_halves, t_fulls):
        d = tf - th
        per_trial.append(work_per_call * (reps - half) / d if d > 0
                         else work_per_call * reps / tf)
    per_trial.sort()
    spread = {
        "min": round(per_trial[0], 2),
        "median": round(per_trial[len(per_trial) // 2], 2),
        "max": round(per_trial[-1], 2),
        "trials": len(per_trial),
        "estimator": "minima-differenced",
    }
    return rate, spread


def measure(env, states, sols, solve, batch, reps, trials, device):
    """One warm call, then ``trials`` pairs of timed chains; returns
    :func:`estimate` of them."""
    timer = profiling.Timer(device)

    def timed_chain(n):
        cur = sols
        with timer.phase(f"chain of {n}") as box:
            for _ in range(n):
                cur, _ = solve(states, cur)
        return box["seconds"]

    with timer.phase("warm"):
        first, trace = solve(states, sols)
    if env.ilqr.mode == "compat":
        finite = (torch.isfinite(trace).all(1)
                  & torch.isfinite(first.traj.qpos).flatten(1).all(1))
        print(f"bench: {int(finite.sum())} of {batch} instances end their "
              "first solve finite", file=sys.stderr)
    del first, trace

    half = max(reps // 2, 1)
    t_halves, t_fulls = [], []
    for _ in range(trials):
        t_halves.append(timed_chain(half))
        t_fulls.append(timed_chain(reps))
    return estimate(t_halves, t_fulls, batch * env.ilqr.iterations, reps)


def _attempt(env_name, mode, engine, batch, reps, trials, dtype, device):
    """Build and measure at one batch; returns (rate, spread)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    env, states, sols, solve = build(env_name, mode, engine, batch, dtype,
                                     device)
    rate, spread = measure(env, states, sols, solve, batch, reps, trials,
                           device)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        print(f"bench: peak device memory {peak:.2f} GiB at B={batch}",
              file=sys.stderr)
    return rate, spread


def main(device=None) -> int:
    env_name = os.environ.get("ILQG_BENCH_ENV", "pendulum")
    batch = int(os.environ.get("ILQG_BENCH_BATCH", "0")) or \
        DEFAULT_BATCH.get(env_name, 8192)
    reps = int(os.environ.get("ILQG_BENCH_REPS", "4"))
    trials = int(os.environ.get("ILQG_BENCH_TRIALS", "3"))
    mode = os.environ.get("ILQG_BENCH_MODE", "tassa")
    engine = os.environ.get("ILQG_BENCH_ENGINE", "ad")
    backoff = os.environ.get("ILQG_BENCH_BACKOFF", "1") != "0"
    dtype_name = os.environ.get("ILQG_BENCH_DTYPE", "float64")
    dtype = DTYPES[dtype_name]
    min_batch = MIN_BATCH.get(env_name, 256)
    dev = resolve_device(device)
    card = profiling.device_line(dev)

    result, errors = None, []
    while True:
        try:
            result = _attempt(env_name, mode, engine, batch, reps, trials,
                              dtype, dev)
            break
        except torch.cuda.OutOfMemoryError as e:
            errors.append(f"B={batch}: {type(e).__name__}: {str(e)[:200]}")
        # outside the handler, once the failed attempt's frames are gone,
        # so that its tensors and captured graphs give their memory back
        gc.collect()
        solver.clear_graphs()
        if not backoff or batch // 2 < min_batch:
            break
        batch //= 2

    base_path = ROOT / "baselines.json"
    base = json.loads(base_path.read_text()) if base_path.exists() else {}
    ref = base.get(env_name, {}).get("ilqr_iters_per_s")

    suffix = "" if (mode, engine) == ("tassa", "ad") else f"_{mode}_{engine}"
    if result is not None:
        rate, spread = result
        line = {
            "metric": f"ilqr_iters_per_s_{env_name}_batch{batch}{suffix}",
            "value": round(rate, 2),
            "unit": "iLQR iterations/s/chip",
            "vs_baseline": round(rate / ref, 2) if ref else None,
            "spread": spread,
            "batch": batch,
            "device": card,
            "dtype": dtype_name,
        }
        if errors:
            line["backoff_from"] = errors
        print(json.dumps(line))
        return 0
    print(json.dumps({
        "metric": f"ilqr_iters_per_s_{env_name}{suffix}",
        "value": 0,
        "unit": "iLQR iterations/s/chip",
        "vs_baseline": None,
        "errors": errors,
        "device": card,
        "dtype": dtype_name,
    }))
    return 1


if __name__ == "__main__":
    sys.exit(main())
