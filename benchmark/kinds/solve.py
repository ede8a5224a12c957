"""A closed loop of batched solves through the program's batch layer
(``parallel/batch.init_batched``, whose initial rollout is part of the
timed work, then ``make_batched_solve``), each on a fresh batch of draws
from the pool made in set-up.

Set-up warms up one iteration at the cell's own shapes (which captures the
constraint solver's CUDA graphs and loads the Riccati kernel) and no whole
solve.  The window runs whole solves until ``--seconds`` have passed.  Of
each solve it keeps ``per_solve`` instances drawn from the seed (the whole
batch where that is the batch); the check compares ``solves`` of the
window's solves drawn from the seed, and the reference solves the kept
instances of each as one batch, from the same draws.
"""

from __future__ import annotations

import time

import torch

from benchmark import check, program
from benchmark.reference import drive
from benchmark.yardstick import inputs


def _rows(sol, trace) -> dict:
    return {"cost": trace, "qpos": sol.traj.qpos, "qvel": sol.traj.qvel,
            "ctrl": sol.traj.ctrl, "K": sol.K, "k": sol.k, "mu": sol.mu}


class Program:
    """A batched solve by the program from a batch of draws; returns the
    rows the check compares.  Keeps its last inputs and outputs for the
    traced iteration."""

    def __init__(self, env, traffic: dict, dev):
        from ilqg_mujoco_torch.parallel import batch as pbatch
        self.pbatch, self.env, self.dev = pbatch, env, dev
        self.B, self.noise = traffic["batch"], traffic["qpos_noise"]
        self.solve = pbatch.make_batched_solve(env)
        self.last = None

    def _init(self, noise):
        return self.pbatch.init_batched(self.env, self.B, self.noise,
                                        noise=noise, device=self.dev)

    def warm(self, noise):
        program.iterate(self.env, *self._init(noise))

    def __call__(self, noise) -> dict:
        states, sols = self._init(noise)
        sols, trace = self.solve(states, sols)
        self.last = (states, sols)
        return _rows(sols, trace)

    def phases(self):
        return program.iteration_phases(self.env, *self.last)

    def release(self):
        self.last = None


class Control:
    """The reference in ``dtype`` in the program's place."""

    def __init__(self, conf, traffic, dev, dtype=torch.float32):
        self.env = drive.build(conf, dtype, dev)
        self.noise = traffic["qpos_noise"]

    def warm(self, noise):
        pass

    def __call__(self, noise):
        rows = drive.solve(self.env, noise, self.noise)
        return {k: v.double() for k, v in rows.items()}

    def release(self):
        pass


class Loop:
    def __init__(self, conf, traffic, seed, dev, solver):
        self.conf, self.traffic, self.seed, self.dev = conf, traffic, seed, dev
        self.solver = solver
        self.B, self.iterations = traffic["batch"], conf["iterations"]

    def _kept(self, s: int) -> list:
        return inputs.instances(self.seed, s, self.B,
                                self.traffic["check"]["per_solve"])

    def setup(self):
        self.pool = inputs.noise_pool(self.seed, self.traffic["pool"] + 1,
                                      self.B, self.conf["nq"], self.dev)
        self.solver.warm(self.pool[-1])
        program.sync(self.dev)

    def window(self, seconds: float) -> dict:
        n = self.traffic["pool"]
        kept, times = [], []
        replays = program.cg_replays()
        program.sync(self.dev)
        t0 = time.perf_counter()
        while True:
            s = len(times)
            rows = self.solver(self.pool[s % n])
            idx = torch.as_tensor(self._kept(s), device=self.dev)
            kept.append({k: v[idx] for k, v in rows.items()})
            program.sync(self.dev)
            times.append(time.perf_counter() - t0)
            if times[-1] >= seconds:
                break
        self.kept = kept
        return {"kind": "solve", "window_s": times[-1], "solves": len(times),
                "batch": self.B, "iterations": self.iterations,
                "solve_ends_s": times,
                "cg_replays": program.cg_replays() - replays}

    def phases(self):
        return self.solver.phases()

    def release(self):
        self.solver.release()

    def compared(self) -> list:
        """[(program rows, draws)] of the compared solves' kept
        instances."""
        n = self.traffic["pool"]
        chosen = inputs.choose(self.seed, list(range(len(self.kept))),
                               self.traffic["check"]["solves"])
        return [({k: v.cpu() for k, v in self.kept[s].items()},
                 self.pool[s % n][self._kept(s)].cpu()) for s in chosen]


def reference(env, draws, prog, traffic) -> dict:
    return drive.solve(env, draws, traffic["qpos_noise"])


def answers(prog: dict, ref: dict):
    """Each instance of a group."""
    for i in range(prog["cost"].shape[0]):
        yield ({k: v[i:i + 1] for k, v in prog.items()},
               {k: v[i:i + 1] for k, v in ref.items()})


def numbers(prog: dict, ref: dict) -> dict:
    """``cost``: the cost trace, every iteration; ``traj``: the solved
    trajectory (qpos, qvel, ctrl); ``gain``: K and k; ``mu``: the
    regularisation the solve ends with."""
    return {"cost": check.relative(prog["cost"], ref["cost"]),
            "traj": max(check.widest(prog[f], ref[f], 1.0)
                        for f in ("qpos", "qvel", "ctrl")),
            "gain": max(check.widest(prog[f], ref[f], check.TINY)
                        for f in ("K", "k")),
            "mu": check.relative(prog["mu"], ref["mu"])}


def attempted(rec) -> int:
    return rec["solves"] * rec["batch"]


def describe(rec) -> str:
    return (f"window: {rec['solves']} solves of B={rec['batch']} in "
            f"{rec['window_s']!r} s; ends {rec['solve_ends_s']}")
