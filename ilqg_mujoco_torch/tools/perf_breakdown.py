"""Per-phase breakdown of one batched iLQR iteration on one card, the
counterpart of the JAX package's ``tools/perf_breakdown.py``.

    ILQG_BENCH_ENV=hopper ILQG_BENCH_BATCH=256 \\
        python -m ilqg_mujoco_torch.tools.perf_breakdown

Times, with ``utils/profiling.Timer`` (CUDA events, a synchronisation on
the end event of each phase), the functions the port's solve runs, each on
the whole batch:

- ``linearize``: ``ops/linearize.linearize_traj`` of the stored trajectory;
- ``backward``: ``ilqr.backward_compat`` in compat mode (on the cart-pole
  the Riccati kernel), ``ilqr.backward_pass_tassa`` in tassa mode;
- ``rollout_x1``: one ``ilqr.forward_pass``;
- ``linesearch_x{len(alphas)}``: ``ilqr.linesearch_rollouts``, which rolls
  out alpha 0 and every alpha of the grid as one batch of
  (len(alphas) + 1) x B instances;
- ``full_solve_{iterations}it``: ``ilqr.solve``.

Each phase runs once to warm up (the CG's graph captures) and then
``reps`` times.  Separately fenced phases each pay their own launches and
synchronisation, so they need not sum to the solve's iteration.  Prints
the Timer's table and one JSON line with the JAX tool's keys; ``device``
is the card's name and power limit.

Env knobs: ILQG_BENCH_ENV (hopper), ILQG_BENCH_BATCH (256),
ILQG_BENCH_MODE (tassa|compat; tassa), ILQG_BENCH_ENGINE (ad|fd|exact;
ad), ILQG_BENCH_REPS (10).  Runs in float64, from the bench's initial
states (qpos noise 0.01 from a generator seeded with 0).
"""

from __future__ import annotations

import json
import os
import sys

import torch

from .. import ilqr
from ..models import envs
from ..ops.linearize import linearize_traj
from ..parallel import batch as pbatch
from ..physics import collision, constraint, smooth
from ..physics.model import Model, make_state, resolve_device
from ..utils import profiling

NOISE_SEED = 0


def count_nefc(model: Model, device) -> int:
    """Constraint rows of one state at qpos0: limit rows and every contact
    slot's rows (the JAX tool's count)."""
    s0 = make_state(model, 1, device=device)
    kin = smooth.kinematics(model, s0.qpos)
    con = collision.collide(model, kin.geom_xpos, kin.geom_xmat)
    efc = constraint.make_efc(model, kin, s0.qpos, s0.qvel, con)
    return efc.J.shape[-2]


def main(device=None) -> int:
    env_name = os.environ.get("ILQG_BENCH_ENV", "hopper")
    B = int(os.environ.get("ILQG_BENCH_BATCH", "256"))
    mode = os.environ.get("ILQG_BENCH_MODE", "tassa")
    engine = os.environ.get("ILQG_BENCH_ENGINE", "ad")
    reps = int(os.environ.get("ILQG_BENCH_REPS", "10"))
    dev = resolve_device(device)

    env = envs.make(env_name, mode=mode, engine=engine)
    m, cfg, cost_fn = env.model, env.ilqr, env.cost_fn
    gen = torch.Generator().manual_seed(NOISE_SEED)
    sb, sols = pbatch.init_batched(env, B, qpos_noise=0.01, generator=gen,
                                   device=dev)
    lin = linearize_traj(m, sols.traj, cost_fn, cfg.lin)

    if mode == "compat":
        backward = lambda: ilqr.backward_compat(m, sols.traj, lin, cfg)
    else:
        backward = lambda: ilqr.backward_pass_tassa(m, sols.traj, lin,
                                                    cost_fn, sols.mu, cfg)
    ls_name = f"linesearch_x{len(cfg.alphas)}"
    full_name = f"full_solve_{cfg.iterations}it"
    phases = {
        "linearize": lambda: linearize_traj(m, sols.traj, cost_fn, cfg.lin),
        "backward": backward,
        "rollout_x1": lambda: ilqr.forward_pass(m, sb, sols, cfg),
        ls_name: lambda: ilqr.linesearch_rollouts(m, cost_fn, sb, sols,
                                                  sols.K, sols.k, cfg),
        full_name: lambda: ilqr.solve(m, cost_fn, sb, sols, cfg),
    }
    for fn in phases.values():          # warm-up: the CG's graph captures
        fn()

    t = profiling.Timer(dev)
    for _ in range(reps):
        for name, fn in phases.items():
            with t.phase(name):
                fn()
    t.report()

    per_lin = t.times["linearize"] / t.counts["linearize"]
    per_full = t.times[full_name] / t.counts[full_name]
    print(json.dumps({
        "env": env_name, "batch": B, "mode": mode, "engine": engine,
        "horizon": cfg.horizon, "nv": m.nv, "nu": m.nu,
        "nefc": count_nefc(m, dev),
        "device": profiling.device_line(dev),
        "ms_linearize": round(per_lin * 1e3, 3),
        "ms_backward": round(t.times["backward"] / reps * 1e3, 3),
        "ms_rollout": round(t.times["rollout_x1"] / reps * 1e3, 3),
        "ms_linesearch": round(t.times[ls_name] / reps * 1e3, 3),
        "ms_full_iteration": round(per_full / cfg.iterations * 1e3, 3),
        "us_per_instance_iteration": round(
            per_full / cfg.iterations / B * 1e6, 4),
        "ilqr_iters_per_s": round(B * cfg.iterations / per_full, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
