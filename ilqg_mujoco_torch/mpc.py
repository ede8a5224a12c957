"""Receding-horizon MPC loop: the port of ``ilqg_mujoco_tpu/mpc.py``,
the analog of InvertedPendulum::forward()
(reference src/inverted_pendulum/inverted_pendulum.cpp:19-30).

Per frame (one reference render-loop tick, cmd/basic.cpp:158-179), for
every instance of the batch:
  1. re-solve the horizon problem from the current env state;
  2. apply the first optimized control;
  3. advance the real environment one step.

The solver state persists across frames like the reference's long-lived
ILQR object: that warm start is what makes 10 iterations per frame enough.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import ilqr
from .models.envs import Env
from .physics import forward as fwd
from .physics.model import State, make_state, stack_states


class MPCOut(NamedTuple):
    env_states: State        # (B, frames, ...) trajectory of the real system
    controls: torch.Tensor   # (B, frames, nu) applied controls
    cost_trace: torch.Tensor  # (B, frames, iterations) per-iteration costs
    step_cost: torch.Tensor  # (B, frames) running cost of the real system
    final_state: State = None
    final_sol: ilqr.ILQRState = None


def mpc_step(env: Env, env_state: State, sol: ilqr.ILQRState):
    """One MPC frame.  Returns (env_state', sol', (u0, cost_trace,
    step_cost))."""
    model, cfg = env.model, env.ilqr
    sol, cost_trace = ilqr.solve(model, env.cost_fn, env_state, sol, cfg)
    u0 = sol.traj.ctrl[:, 0]
    env_next = fwd.step(model, env_state.replace(ctrl=u0))
    step_cost = env.cost_fn(env_state.qpos, env_state.qvel, u0)
    return env_next, sol, (u0, cost_trace, step_cost)


def init(env: Env, x0: State = None, device=None, dtype=torch.float64):
    """Warm in the env (the ctor's free steps) and build the solver state.
    Without ``x0`` one instance starts at qpos0 on ``device``."""
    model = env.model
    s = make_state(model, 1, dtype, device) if x0 is None else x0
    for _ in range(env.warm_steps):
        s = fwd.step(model, s)
    return s, ilqr.init_solver(model, s, env.ilqr)


def run(env: Env, frames: int, x0: State = None,
        sol0: ilqr.ILQRState = None, device=None,
        dtype=torch.float64) -> MPCOut:
    """Full MPC rollout of ``frames`` frames.  ``sol0`` resumes from a solver
    state and then requires the matching ``x0``."""
    if sol0 is not None:
        if x0 is None:
            raise ValueError("sol0 (resume) requires the matching x0")
        s, sol = x0, sol0
    else:
        s, sol = init(env, x0, device, dtype)
    states, us, traces, costs = [], [], [], []
    for _ in range(frames):
        states.append(s)
        s, sol, (u0, trace, c) = mpc_step(env, s, sol)
        us.append(u0)
        traces.append(trace)
        costs.append(c)
    return MPCOut(env_states=stack_states(states, 1),
                  controls=torch.stack(us, 1),
                  cost_trace=torch.stack(traces, 1),
                  step_cost=torch.stack(costs, 1),
                  final_state=s, final_sol=sol)
