"""The program under test as every traffic kind drives it: its env from a
configuration file, its CG-replay counter, one iteration of its solve loop
phase by phase, and the traced iteration of a ``--trace 1`` run.

What belongs to one kind of traffic (its loop, its adapter of the program,
its control and the numbers its check compares) is in
``kinds/<kind>.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import trace as tr


def program_env(conf: dict):
    """The program's env for a configuration file's keys: the program's
    own env, set to what the file states; raises where the program's model
    departs from it."""
    from ilqg_mujoco_torch.models import envs
    lin = conf["lin"]
    env = envs.make(conf["env"], mode=conf["mode"], engine=lin["engine"])
    m = env.model
    integrator = {0: "Euler", 1: "RK4"}[int(m.opt.integrator)]
    have = {"nq": m.nq, "nv": m.nv, "nu": m.nu, "integrator": integrator,
            "timestep": m.opt.timestep,
            "solver_iterations": m.opt.iterations,
            "solver_tolerance": m.opt.tolerance}
    bad = {k: (v, conf[k]) for k, v in have.items() if v != conf[k]}
    if bad:
        raise ValueError(f"the program's model departs from the "
                         f"configuration (program, file): {bad}")
    cfg = dataclasses.replace(
        env.ilqr, horizon=conf["horizon"], iterations=conf["iterations"],
        mode=conf["mode"], mu=conf["mu"], reg_init=conf["reg_init"],
        value_scaling=conf["value_scaling"], mu_min=conf["mu_min"],
        mu_max=conf["mu_max"], mu_factor=conf["mu_factor"],
        alphas=tuple(conf["alphas"]), control_limits=False, backward="scan",
        lin=dataclasses.replace(
            env.ilqr.lin, engine=lin["engine"], eps=lin["eps"],
            niter=lin["niter"], nwarmup=lin["nwarmup"],
            compat_transpose_A=lin["compat_transpose_A"],
            compat_scramble_B=lin["compat_scramble_B"],
            chunk_knots=lin["chunk_knots"]))
    return dataclasses.replace(env, ilqr=cfg, warm_steps=conf["warm_steps"])


def cg_replays() -> int:
    """The program's count of CG-iteration graph replays."""
    from ilqg_mujoco_torch.physics import solver
    return sum(solver._GRAPHS.replays.values())


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def iterate(env, state, sol):
    """One iteration of the program's solve loop (the warm-up)."""
    from ilqg_mujoco_torch import ilqr
    it = (ilqr.iterate_compat if env.ilqr.mode == "compat"
          else ilqr.iterate_tassa)
    return it(env.model, env.cost_fn, state, sol, env.ilqr)


def iteration_phases(env, x0, sol):
    """[(phase, fn)] of one iteration of the program's solve loop from
    (x0, sol), called one by one: the inputs of each phase are made first,
    outside the phases."""
    from ilqg_mujoco_torch import ilqr
    from ilqg_mujoco_torch.ops.linearize import linearize_traj
    m, cost, cfg = env.model, env.cost_fn, env.ilqr
    lin = linearize_traj(m, sol.traj, cost, cfg.lin)
    if cfg.mode == "compat":
        return [("forward", lambda: ilqr.forward_pass(m, x0, sol, cfg)),
                ("linearize", lambda: linearize_traj(m, sol.traj, cost,
                                                     cfg.lin)),
                ("backward", lambda: ilqr.backward_compat(m, sol.traj, lin,
                                                          cfg))]
    K, k, _, _, ok = ilqr.backward_pass_tassa(m, sol.traj, lin, cost, sol.mu,
                                              cfg)
    trajs, costs = ilqr.linesearch_rollouts(m, cost, x0, sol, K, k, cfg)
    return [("linearize", lambda: linearize_traj(m, sol.traj, cost, cfg.lin)),
            ("backward", lambda: ilqr.backward_pass_tassa(
                m, sol.traj, lin, cost, sol.mu, cfg)),
            ("forward", lambda: ilqr.linesearch_rollouts(
                m, cost, x0, sol, K, k, cfg)),
            ("select", lambda: ilqr.linesearch_select(
                cost, sol, K, k, ok, trajs, costs, cfg))]


def traced(loop, device) -> dict:
    """The per-phase milliseconds and the profile of one iteration."""
    named = loop.phases()
    out = {"phase_ms": tr.time_phases(named, device)}
    out.update(tr.profile_phases(named, device))
    return out
