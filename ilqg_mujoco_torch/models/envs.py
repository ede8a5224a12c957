"""Task/environment layer: (model asset, step cost, solver config) records,
the port of ``ilqg_mujoco_tpu/models/envs.py`` for the cart-pole (the
reference's only complete env, reference inc/inverted_pendulum/*) and the
hopper.

The cost contract is the reference's ``stepCostFn_t``
(reference inc/mjderivative.h:5): one scalar per state, here
``cost(qpos, qvel, ctrl)`` on tensors with any leading batch dims.  The
humanoid and tumbler envs come with quaternion states (slice 4).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable

from ..ilqr import ILQRConfig
from ..ops.linearize import LinearizeConfig
from ..physics import mjcf
from ..physics.model import Model

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"


@dataclasses.dataclass(frozen=True)
class Env:
    name: str
    model: Model
    cost_fn: Callable
    ilqr: ILQRConfig
    warm_steps: int = 0   # env warm-in steps before the first solve


_CACHE = {}


def pendulum_cost(qpos, qvel, ctrl):
    """inc/inverted_pendulum/cost.h:7-17."""
    return (1.0 * qpos[..., 0] ** 2 + 10.0 * qpos[..., 1] ** 2
            + 1.0 * qvel[..., 0] ** 2 + 10.0 * qvel[..., 1] ** 2
            + 1.0 * ctrl[..., 0] ** 2)


def pendulum(mode: str = "compat", engine: str = "fd") -> Env:
    """Cart-pole swing-up/balance.

    Cost 1*qpos0^2 + 10*qpos1^2 + 1*qvel0^2 + 10*qvel1^2 + 1*ctrl0^2; dims
    nv=2, nu=1, N=20, 10 iterations per MPC step
    (inc/inverted_pendulum/inverted_pendulum.h:20-24); the env warms in with
    10 free steps before the first solve
    (src/inverted_pendulum/inverted_pendulum.cpp:12-13)."""
    return Env(
        name="pendulum", model=_load("cartpole.xml"), cost_fn=pendulum_cost,
        ilqr=ILQRConfig(horizon=20, iterations=10, mode=mode,
                        lin=LinearizeConfig(engine=engine)),
        warm_steps=10)


def hopper_cost(qpos, qvel, ctrl):
    """Track a forward speed of 1 m/s while staying tall and upright, with
    a small ctrl penalty (the JAX package's extension: the reference ships
    the asset without an env)."""
    return (2.0 * (qvel[..., 0] - 1.0) ** 2
            + 10.0 * (qpos[..., 1] - 1.25) ** 2
            + 1.0 * qpos[..., 2] ** 2
            + 0.1 * (qvel[..., 3:] ** 2).sum(-1)
            + 1e-3 * (ctrl ** 2).sum(-1))


def hopper(mode: str = "tassa", engine: str = "ad") -> Env:
    """Planar hopper (reference res/hopper.xml in local coordinates): nq =
    nv = 6, nu = 3, contacts with the floor and between the links, Euler at
    dt=0.002; N=40, 10 iterations per solve."""
    return Env(
        name="hopper", model=_load("hopper.xml"), cost_fn=hopper_cost,
        ilqr=ILQRConfig(horizon=40, iterations=10, mode=mode,
                        lin=LinearizeConfig(engine=engine)),
        warm_steps=0)


REGISTRY = {"pendulum": pendulum, "hopper": hopper}


def _load(asset: str) -> Model:
    if asset not in _CACHE:
        _CACHE[asset] = mjcf.load_model(str(ASSETS / asset))
    return _CACHE[asset]


def make(name: str, **kw) -> Env:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"env {name!r} is not ported yet (quaternion states: slice 4)")
    return REGISTRY[name](**kw)
