"""The reference's entry points, as the check calls them: an environment
built from a configuration's JSON file and its cost beside it, a batched
solve from the seeded draws, and a closed MPC loop."""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
from typing import Callable

import torch

from . import forward as fwd
from . import ilqr, mjcf
from .linearize import LinearizeConfig
from .model import Model, make_state

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RefEnv:
    model: Model
    cost_fn: Callable
    cfg: ilqr.ILQRConfig
    warm_steps: int
    dtype: torch.dtype
    device: torch.device


def load_cost(name: str):
    """``make_cost`` of ``configs/<name>.py``."""
    path = CONFIGS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_cost_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_cost


def build(conf: dict, dtype=None, device="cpu") -> RefEnv:
    """The configuration ``conf`` (a configuration file's keys) as the
    reference runs it, in ``dtype`` (the configuration's own by default)."""
    if dtype is None:
        dtype = DTYPES[conf["dtype"]]
    if dtype == torch.float32:
        # a float32 control must not fall to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = mjcf.load_model(str(CONFIGS / conf["asset"]))
    lin = conf["lin"]
    cfg = ilqr.ILQRConfig(
        horizon=conf["horizon"], iterations=conf["iterations"],
        mode=conf["mode"], mu=conf["mu"], reg_init=conf["reg_init"],
        value_scaling=conf["value_scaling"], mu_min=conf["mu_min"],
        mu_max=conf["mu_max"], mu_factor=conf["mu_factor"],
        alphas=tuple(conf["alphas"]),
        lin=LinearizeConfig(
            eps=lin["eps"], niter=lin["niter"], nwarmup=lin["nwarmup"],
            compat_transpose_A=lin["compat_transpose_A"],
            compat_scramble_B=lin["compat_scramble_B"],
            engine=lin["engine"]))
    return RefEnv(model, load_cost(conf["name"])(model), cfg,
                  conf["warm_steps"], dtype, torch.device(device))


def initial_states(env: RefEnv, noise: torch.Tensor, qpos_noise: float):
    """The reference's qpos0 plus ``qpos_noise`` times the draws."""
    noise = noise.to(env.device, env.dtype)
    s = make_state(env.model, noise.shape[0], env.dtype, env.device)
    return s.replace(qpos=s.qpos + qpos_noise * noise)


def rows(sol: ilqr.ILQRState, trace: torch.Tensor) -> dict:
    """What the check compares of a solve, one row per instance."""
    return {"cost": trace, "qpos": sol.traj.qpos, "qvel": sol.traj.qvel,
            "ctrl": sol.traj.ctrl, "K": sol.K, "k": sol.k, "mu": sol.mu}


def solve(env: RefEnv, noise: torch.Tensor, qpos_noise: float) -> dict:
    """A batched solve from qpos0 + qpos_noise * noise: the initial
    rollout, then the configuration's iterations."""
    s = initial_states(env, noise, qpos_noise)
    sol = ilqr.init_solver(env.model, s, env.cfg)
    sol, trace = ilqr.solve(env.model, env.cost_fn, s, sol, env.cfg)
    return rows(sol, trace)


def mpc_init(env: RefEnv, noise: torch.Tensor, qpos_noise: float):
    """The loop's first state, after the env's warm-in steps from qpos0 +
    qpos_noise * noise, and its initial solver state."""
    s = initial_states(env, noise, qpos_noise)
    for _ in range(env.warm_steps):
        s = fwd.step(env.model, s)
    return s, ilqr.init_solver(env.model, s, env.cfg)


def mpc_frame(env: RefEnv, s, sol):
    """One frame: a warm-started solve from ``s``, then one env step under
    its first control.  Returns (next state, solver state, the control
    applied, the solve's cost trace and gains)."""
    sol, trace = ilqr.solve(env.model, env.cost_fn, s, sol, env.cfg)
    u0 = sol.traj.ctrl[:, 0]
    out = {"u0": u0, "cost": trace, "K": sol.K, "k": sol.k}
    return fwd.step(env.model, s.replace(ctrl=u0)), sol, out


def mpc(env: RefEnv, noise: torch.Tensor, qpos_noise: float,
        frames: int) -> dict:
    """A closed MPC loop of ``frames`` frames: per frame the state it
    stepped to, the control applied, the solve's cost trace and gains,
    stacked along dim 1."""
    s, sol = mpc_init(env, noise, qpos_noise)
    rows = []
    for _ in range(frames):
        s, sol, out = mpc_frame(env, s, sol)
        rows.append(dict(out, qpos=s.qpos, qvel=s.qvel))
    return {k: torch.stack([r[k] for r in rows], 1) for k in rows[0]}
