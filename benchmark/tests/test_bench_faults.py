"""A run whose timed path is broken underneath comes out not correct, and
so does the control (the reference in float32 in the program's place).
The harness's look for a card is skipped (``device="cpu"``); the rest of
the run is the benchmark's own."""

import dataclasses
import functools

import pytest
import torch

from benchmark import harness, program
from benchmark.kinds import mpc, solve
from benchmark.tests.conftest import run_cell, tiny


def _initial_rows(env, sols):
    t = sols.traj
    c = env.cost_fn(t.qpos, t.qvel, t.ctrl).sum(-1)
    return {"cost": c[:, None].expand(-1, env.ilqr.iterations),
            "qpos": t.qpos, "qvel": t.qvel, "ctrl": t.ctrl, "K": sols.K,
            "k": sols.k, "mu": sols.mu}


class Unchanged(solve.Program):
    """A solve that returns its initial solver state."""

    def __call__(self, noise):
        states, sols = self._init(noise)
        self.last = (states, sols)
        return _initial_rows(self.env, sols)


class FirstOnly(solve.Program):
    """A solve that stops after its first iteration and returns that
    state, its cost trace held at that iteration's cost."""

    def __init__(self, env, traffic, dev):
        super().__init__(env, traffic, dev)
        self.n = env.ilqr.iterations
        one = dataclasses.replace(env, ilqr=dataclasses.replace(
            env.ilqr, iterations=1))
        self.solve = self.pbatch.make_batched_solve(one)

    def __call__(self, noise):
        rows = super().__call__(noise)
        c = rows["cost"]
        return dict(rows, cost=c[:, -1:].expand(-1, self.n))


class Half(solve.Program):
    """A solve of the first half of the batch; the rest left as it came."""

    def __call__(self, noise):
        rows = super().__call__(noise)
        _, sols0 = self._init(noise)
        h = noise.shape[0] // 2
        init = _initial_rows(self.env, sols0)
        return {k: torch.cat([v[:h], init[k][h:]]) for k, v in rows.items()}


class Altered(solve.Program):
    """A solve whose first control is altered where it is produced."""

    def __call__(self, noise):
        rows = super().__call__(noise)
        ctrl = rows["ctrl"].clone()
        ctrl[:, 0] += 1e-3
        return dict(rows, ctrl=ctrl)


class FrozenMPC(mpc.Program):
    """A frame that returns the state it was given, unstepped."""

    def frame(self, state, sol):
        _, sol2, out = super().frame(state, sol)
        return state, sol2, out


class AlteredMPC(mpc.Program):
    """A frame whose applied control is altered where it is produced."""

    def frame(self, state, sol):
        nxt, sol2, out = super().frame(state, sol)
        return nxt, sol2, dict(out, u0=out["u0"] + 1e-3)


def _factory(cls):
    return lambda conf, traffic, dev: cls(program.program_env(conf), traffic,
                                          dev)


def _humanoid(spec):
    """The humanoid cut for the CPU: ``tiny`` at a horizon of 3."""
    tiny(spec)
    spec.conf["horizon"] = 3


SOLVE_CUTS = {"cartpole_solve_b16384": tiny, "humanoid_solve_b16": _humanoid}


@pytest.mark.parametrize("cell,fault", [
    ("cartpole_solve_b16384", Unchanged), ("cartpole_solve_b16384", FirstOnly),
    ("cartpole_solve_b16384", Half), ("cartpole_solve_b16384", Altered),
    ("humanoid_solve_b16", FirstOnly)],
    ids=lambda c: getattr(c, "__name__", c))
def test_solve_fault_is_not_correct(cell, fault):
    rc, line, _ = run_cell(cell, solver=_factory(fault),
                           tweak=SOLVE_CUTS[cell])
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


def test_humanoid_sound_run_is_correct():
    """The humanoid's full check (every iteration's cost, the trajectory,
    the gains and mu) passes a sound run at a CPU size."""
    rc, line, _ = run_cell("humanoid_solve_b16", tweak=_humanoid)
    assert rc == 0 and line["correct"] is True
    assert set(line["check"]) == {"cost", "traj", "gain", "mu"}


@pytest.mark.parametrize("fault", [FrozenMPC, AlteredMPC],
                         ids=lambda c: c.__name__)
def test_mpc_fault_is_not_correct(fault):
    rc, line, _ = run_cell("cartpole_mpc_b1", solver=_factory(fault), seed=5)
    assert rc == 0 and line["attempted"] == 1
    assert line["correct"] is False


@pytest.mark.parametrize("cell", ["cartpole_solve_b16384", "cartpole_mpc_b1"])
def test_float32_control_is_not_correct(cell):
    k = harness.kind(harness.load_spec(cell).traffic["kind"])
    ctl = functools.partial(k.Control, dtype=torch.float32)
    rc, line, _ = run_cell(cell, solver=ctl, tweak=tiny)
    assert rc == 0 and line["correct"] is False
