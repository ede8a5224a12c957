"""Closed-loop MPC through the program's ``mpc.mpc_step``: one
warm-started solve and one env step a frame, from the seed's state after
the env's warm-in steps (``mpc.init``, in set-up).

Set-up warms up one iteration at the loop's shapes and no whole frame.
The window runs whole frames until ``--seconds`` have passed; each frame's
row is the state the frame stepped to, the control it applied, its
solve's cost trace and gains.  The check compares every frame with the
reference's own closed loop from the same draws.
"""

from __future__ import annotations

import time

import torch

from benchmark import check, program
from benchmark.reference import drive
from benchmark.yardstick import inputs


class Program:
    """The program's MPC loop at one batch: its initial state and solver
    state from the draws (``mpc.init``), and one ``mpc.mpc_step`` a
    frame."""

    def __init__(self, env, traffic: dict, dev):
        self.env, self.dev, self.noise = env, dev, traffic["qpos_noise"]
        self.last = None

    def init(self, noise):
        from ilqg_mujoco_torch import mpc
        from ilqg_mujoco_torch.physics.model import make_state
        s = make_state(self.env.model, noise.shape[0], noise.dtype, self.dev)
        s = s.replace(qpos=s.qpos + self.noise * noise)
        return mpc.init(self.env, s)

    def warm(self, state, sol):
        program.iterate(self.env, state, sol)

    def frame(self, state, sol):
        """(the state stepped to, the solver state, the frame's other
        answers)."""
        from ilqg_mujoco_torch import mpc
        nxt, sol2, (u0, trace, _) = mpc.mpc_step(self.env, state, sol)
        self.last = (state, sol)
        return nxt, sol2, {"u0": u0, "cost": trace, "K": sol2.K,
                           "k": sol2.k}

    def phases(self):
        return program.iteration_phases(self.env, *self.last)

    def release(self):
        self.last = None


class Control:
    """The reference's loop in ``dtype`` in the program's place."""

    def __init__(self, conf, traffic, dev, dtype=torch.float32):
        self.env = drive.build(conf, dtype, dev)
        self.noise = traffic["qpos_noise"]

    def init(self, noise):
        return drive.mpc_init(self.env, noise, self.noise)

    def warm(self, state, sol):
        pass

    def frame(self, state, sol):
        s, sol, out = drive.mpc_frame(self.env, state, sol)
        return s, sol, {k: v.double() for k, v in out.items()}

    def release(self):
        pass


class Loop:
    def __init__(self, conf, traffic, seed, dev, solver):
        self.conf, self.traffic, self.seed, self.dev = conf, traffic, seed, dev
        self.solver = solver

    def setup(self):
        self.draws = inputs.noise_pool(self.seed, 1, self.traffic["batch"],
                                       self.conf["nq"], self.dev)[0]
        self.state, self.sol = self.solver.init(self.draws)
        self.solver.warm(self.state, self.sol)
        program.sync(self.dev)

    def window(self, seconds: float) -> dict:
        rows, frame_s = [], []
        s, sol = self.state, self.sol
        program.sync(self.dev)
        t0 = last = time.perf_counter()
        while True:
            s, sol, out = self.solver.frame(s, sol)
            rows.append(dict(out, qpos=s.qpos, qvel=s.qvel))
            program.sync(self.dev)
            now = time.perf_counter()
            frame_s.append(now - last)
            last = now
            if now - t0 >= seconds:
                break
        self.rows = rows
        return {"kind": "mpc", "window_s": last - t0, "frames": len(rows),
                "batch": self.traffic["batch"], "frame_s": frame_s,
                "iterations": self.conf["iterations"]}

    def phases(self):
        return self.solver.phases()

    def release(self):
        self.state = self.sol = None
        self.solver.release()

    def compared(self) -> list:
        """One group: every frame, stacked along dim 1."""
        prog = {k: torch.stack([r[k] for r in self.rows], 1).cpu()
                for k in self.rows[0]}
        return [(prog, self.draws.cpu())]


def reference(env, draws, prog, traffic) -> dict:
    return drive.mpc(env, draws, traffic["qpos_noise"], prog["cost"].shape[1])


def answers(prog: dict, ref: dict):
    """Each frame."""
    for i in range(prog["cost"].shape[1]):
        yield ({k: v[:, i] for k, v in prog.items()},
               {k: v[:, i] for k, v in ref.items()})


def numbers(prog: dict, ref: dict) -> dict:
    """``cost``: the frame's solve's cost trace; ``traj``: the state the
    frame stepped to and the control it applied; ``gain``: K and k."""
    return {"cost": check.relative(prog["cost"], ref["cost"]),
            "traj": max(check.widest(prog[f], ref[f], 1.0)
                        for f in ("qpos", "qvel", "u0")),
            "gain": max(check.widest(prog[f], ref[f], check.TINY)
                        for f in ("K", "k"))}


def attempted(rec) -> int:
    return rec["frames"]


def describe(rec) -> str:
    return (f"window: {rec['frames']} frames in {rec['window_s']!r} s; "
            f"frame seconds {rec['frame_s']}")
