"""Batch layer: the port of ``ilqg_mujoco_tpu/parallel/batch.py`` for one
card.  Every function of the port already takes a leading batch dim of
independent instances, so a batched solve or MPC frame is a plain call; no
mesh is needed on one device.
"""

from __future__ import annotations

import torch

from .. import ilqr, mpc
from ..models.envs import Env
from ..physics.model import State, make_state


def batch_states(env: Env, batch: int, qpos_noise: float = 0.0,
                 noise=None, generator: torch.Generator = None,
                 device=None, dtype=torch.float64) -> State:
    """A batch of initial states at qpos0, perturbed by
    ``qpos_noise * noise`` for diversity.  ``noise`` is a (batch, nq) array
    of standard normal draws (numpy or tensor); without it the draws come
    from ``generator`` on the CPU, so a seed gives the same batch on every
    device."""
    sb = make_state(env.model, batch, dtype, device)
    if qpos_noise > 0.0:
        if noise is None:
            noise = torch.randn((batch, env.model.nq), generator=generator,
                                dtype=torch.float64)
        noise = torch.as_tensor(noise, dtype=dtype).to(sb.qpos.device)
        sb = sb.replace(qpos=sb.qpos + qpos_noise * noise)
    return sb


def make_batched_solve(env: Env):
    """(states, sols) -> (sols', cost traces (B, iterations)): one iLQR
    solve per instance."""
    m, cfg = env.model, env.ilqr

    def solve(states: State, sols: ilqr.ILQRState):
        return ilqr.solve(m, env.cost_fn, states, sols, cfg)
    return solve


def make_batched_mpc_step(env: Env):
    """One MPC frame over a batch: re-solve + apply first control + physics
    step for every instance in lockstep.  (states, sols) -> (states', sols',
    step costs (B,))."""
    def step(states: State, sols: ilqr.ILQRState):
        s2, sol2, (_, _, c) = mpc.mpc_step(env, states, sols)
        return s2, sol2, c
    return step


def init_batched(env: Env, batch: int, qpos_noise: float = 0.01, noise=None,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float64):
    """Batched (states, solver states): each instance rolls out its own
    initial trajectory."""
    sb = batch_states(env, batch, qpos_noise, noise, generator, device, dtype)
    return sb, ilqr.init_solver(env.model, sb, env.ilqr)
