"""Humanoid closed-loop balance run on one card, the counterpart of the
JAX package's ``tools/humanoid_balance.py``: MPC frames of the full
humanoid (nq 28, nv 27) at dt=0.005, written as an npz so that the balance
can be checked offline.

    python -m ilqg_mujoco_torch.tools.humanoid_balance [out.npz]

A host loop of ``mpc.mpc_step``, one frame at a time from one warmed-in
instance, prints each frame's height, largest |u| and |K|, and mu, and
stops at a non-finite state or a fall (height under 0.9 m).  The npz holds
the JAX tool's arrays, qpos (frames, nq), qvel, ctrl, step_cost and
cost_trace, and its JSON summary; ``backend`` is the device's name and
power limit, and ``segment_frames`` is 1 (the JAX tool's segments bound
the size of an XLA program, which the port does not have).  A run that
does not balance (height above 1 m and uprightness above 0.7 at every
frame) is written under ``<out>.failed.npz``.  The default output is
``humanoid_balance.npz`` in the working directory; the JAX package's
artifact ``docs/humanoid_balance.npz``, which
``tests/test_balance_artifact.py`` checks, is refused.

Env knobs: ILQG_HUM_FRAMES (200), ILQG_HUM_HORIZON (30), ILQG_HUM_ITERS
(5), ILQG_HUM_ENGINE (ad|fd|exact; ad), ILQG_HUM_LIMITS (0|1: the boxQP
backward pass within the asset's +-0.4 ctrlrange), ILQG_HUM_ALPHAS
(comma-separated linesearch grid), ILQG_HUM_F64 (0|1: float64; float32
by default, as the JAX tool runs without x64).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import sys
import time

import numpy as np
import torch

from .. import mpc
from ..models import envs
from ..physics.model import resolve_device
from ..utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[2]
JAX_ARTIFACT = ROOT / "docs" / "humanoid_balance.npz"


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    frames = int(os.environ.get("ILQG_HUM_FRAMES", "200"))
    horizon = int(os.environ.get("ILQG_HUM_HORIZON", "30"))
    iters = int(os.environ.get("ILQG_HUM_ITERS", "5"))
    alphas = os.environ.get("ILQG_HUM_ALPHAS", "")
    engine = os.environ.get("ILQG_HUM_ENGINE", "ad")
    dtype = (torch.float64 if os.environ.get("ILQG_HUM_F64", "0") == "1"
             else torch.float32)
    out_path = pathlib.Path(argv[0] if argv else "humanoid_balance.npz")
    if out_path.resolve() == JAX_ARTIFACT.resolve():
        raise ValueError(f"{out_path} is the JAX package's balance artifact;"
                         " write the port's run elsewhere")
    dev = resolve_device(device)

    env = envs.make("humanoid", mode="tassa", engine=engine)
    over = {"horizon": horizon, "iterations": iters}
    if os.environ.get("ILQG_HUM_LIMITS", "0") == "1":
        over["control_limits"] = True
    if alphas:
        over["alphas"] = tuple(float(a) for a in alphas.split(","))
    env = dataclasses.replace(env,
                              ilqr=dataclasses.replace(env.ilqr, **over))

    t0 = time.perf_counter()
    s, sol = mpc.init(env, device=dev, dtype=dtype)
    rec = {k: [] for k in ("qpos", "qvel", "ctrl", "step_cost",
                           "cost_trace")}
    for i in range(frames):
        rec["qpos"].append(s.qpos[0])
        rec["qvel"].append(s.qvel[0])
        s, sol, (u0, trace, cost) = mpc.mpc_step(env, s, sol)
        rec["ctrl"].append(u0[0])
        rec["cost_trace"].append(trace[0])
        rec["step_cost"].append(cost[0])
        h = float(rec["qpos"][-1][2])
        print(f"  frame {i}: height {h:.3f}  "
              f"max|u|={float(u0.abs().max()):.3f} "
              f"max|K|={float(sol.K.abs().max()):.2e} "
              f"mu={float(sol.mu[0]):.2e}  "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
        if not math.isfinite(h):
            print("  non-finite state: aborting the remaining frames",
                  flush=True)
            break
        if h < 0.9:
            print("  fell: aborting the remaining frames", flush=True)
            break
    out = {k: torch.stack(v).cpu().numpy() for k, v in rec.items()}
    elapsed = time.perf_counter() - t0

    qpos = out["qpos"]
    dt = float(env.model.opt.timestep)
    height = qpos[:, 2]
    # z-axis alignment of the torso from the free-joint quaternion (wxyz)
    up = 1.0 - 2.0 * (qpos[:, 4] ** 2 + qpos[:, 5] ** 2)
    summary = {
        "frames": qpos.shape[0], "dt": dt,
        "sim_seconds": qpos.shape[0] * dt,
        "horizon": horizon, "iterations": iters, "segment_frames": 1,
        "height_min": float(height.min()), "height_max": float(height.max()),
        "upright_min": float(up.min()),
        "finite": bool(np.all(np.isfinite(qpos))),
        "balanced": bool(np.all(height > 1.0) and np.all(up > 0.7)),
        "wall_seconds": round(elapsed, 1),
        "backend": profiling.device_line(dev),
    }
    if not summary["balanced"]:
        # a run that does not balance never sits at the path asked for
        out_path = pathlib.Path(f"{out_path}.failed.npz")
    np.savez_compressed(out_path, summary=json.dumps(summary), **out)
    print(json.dumps(summary))
    print("wrote", out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
