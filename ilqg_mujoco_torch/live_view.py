"""Live MPC viewing, the counterpart of ``tools/live_view.py``: the
reference's render loop (reference cmd/basic.cpp:109-196) with the solver
on the card.

Per displayed frame the loop runs one MPC step at B=1 (re-solve, apply the
first control, one physics step), as InvertedPendulum::forward runs once
per render tick (cmd/basic.cpp:158-179), then mirrors the state into a
``mujoco.MjData`` for ``mujoco.viewer.launch_passive``, which loads the
port's own assets.  ``--headless``, or a missing ``mujoco`` or display,
swaps the viewer for a no-op one; the solver stays on the device it was
given.  Each frame's solve is timed by ``profiling.Timer``.

Usage:  python -m ilqg_mujoco_torch.live_view --env pendulum [--frames 600]
        [--fps 60] [--headless] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from . import mpc
from .models import envs
from .utils import profiling

ASSET = {"pendulum": "cartpole.xml", "hopper": "hopper.xml",
         "humanoid": "humanoid.xml"}


class _NullViewer:
    """Viewer stand-in for headless runs: the context-manager and sync
    surface of mujoco.viewer.launch_passive's handle."""

    is_running_flag = True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def is_running(self):
        return self.is_running_flag

    def sync(self):
        pass


def _make_viewer(env_name, headless):
    """(viewer context, mj_model, mj_data); the mj_* are None when
    headless."""
    if headless:
        return _NullViewer(), None, None
    try:
        import mujoco
        import mujoco.viewer
        m = mujoco.MjModel.from_xml_path(str(envs.ASSETS / ASSET[env_name]))
        d = mujoco.MjData(m)
        return mujoco.viewer.launch_passive(m, d), m, d
    except Exception as e:  # no mujoco, GL or display: run headless
        print(f"viewer unavailable ({e!r}); running headless",
              file=sys.stderr)
        return _NullViewer(), None, None


def live_loop(env_name="pendulum", frames=600, fps=60.0, headless=False,
              horizon=None, iterations=None, record=None, device=None,
              dtype=torch.float64):
    """The host render/solve loop on ``device`` (the card unless the CPU is
    asked for).  Returns (visited qpos history (frames, nq), each frame's
    MPC step seconds)."""
    env = envs.make(env_name)
    if horizon or iterations:
        env = dataclasses.replace(env, ilqr=dataclasses.replace(
            env.ilqr,
            horizon=horizon or env.ilqr.horizon,
            iterations=iterations or env.ilqr.iterations))

    s, sol = mpc.init(env, device=device, dtype=dtype)
    timer = profiling.Timer(s.qpos.device)
    viewer, mm, md = _make_viewer(env_name, headless)
    history, seconds = [], []
    period = 1.0 / fps if fps else 0.0
    with viewer as v:
        for _ in range(frames):
            if not v.is_running():
                break
            t0 = time.perf_counter()
            with timer.phase("frame") as box:
                s, sol, _ = mpc.mpc_step(env, s, sol)
            seconds.append(box["seconds"])
            qpos = s.qpos[0].cpu().numpy()
            history.append(qpos)
            if md is not None:
                import mujoco
                md.qpos[:] = qpos
                md.qvel[:] = s.qvel[0].cpu().numpy()
                mujoco.mj_forward(mm, md)
            v.sync()
            # v-sync analog: sleep off the rest of the frame's budget
            dt = time.perf_counter() - t0
            if period > dt:
                time.sleep(period - dt)
    history = np.asarray(history)
    if record:
        np.savez_compressed(record, qpos=history)
    return history, seconds


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env", default="pendulum", choices=sorted(ASSET))
    p.add_argument("--frames", type=int, default=600)
    p.add_argument("--fps", type=float, default=60.0)
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--record", default=None,
                   help="npz path for the visited qpos history")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    a = p.parse_args(argv)
    hist, seconds = live_loop(a.env, a.frames, a.fps, a.headless, a.horizon,
                              a.iterations, a.record, a.device)
    if seconds:
        print(f"ran {len(hist)} frames; MPC step median "
              f"{1e3 * float(np.median(seconds)):.1f} ms; final qpos "
              f"{hist[-1]}")


if __name__ == "__main__":
    main()
