"""Task/environment layer: (model asset, step cost, solver config) records,
the port of ``ilqg_mujoco_tpu/models/envs.py``: the cart-pole (the
reference's only complete env, reference inc/inverted_pendulum/*), the
hopper, the humanoid and the tumbler.

The cost contract is the reference's ``stepCostFn_t``
(reference inc/mjderivative.h:5): one scalar per state, here
``cost(qpos, qvel, ctrl)`` on tensors with any leading batch dims.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable

import torch

from ..ilqr import ILQRConfig
from ..ops.linearize import LinearizeConfig
from ..physics import mjcf
from ..physics.model import Model, on_device

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


def _posture(model: Model, device, dtype) -> torch.Tensor:
    return torch.as_tensor(model.qpos0[7:], dtype=dtype, device=device)


def humanoid_cost(model: Model):
    """Stay tall, upright and centred, hold the posture qpos0[7:], with
    velocity and ctrl penalties (the JAX package's extension)."""
    def cost(qpos, qvel, ctrl):
        up = 1.0 - 2.0 * (qpos[..., 4] ** 2 + qpos[..., 5] ** 2)
        ref = on_device(model, qpos.device, qpos.dtype, _posture)
        return (50.0 * (qpos[..., 2] - 1.4) ** 2
                + 20.0 * (1.0 - up) ** 2
                + 1.0 * (qpos[..., 0] ** 2 + qpos[..., 1] ** 2)
                # the posture hold keeps the knees from yielding over the
                # receding horizon
                + 2.0 * ((qpos[..., 7:] - ref) ** 2).sum(-1)
                + 0.05 * (qvel ** 2).sum(-1)
                + 1e-3 * (ctrl ** 2).sum(-1))
    return cost


def humanoid(mode: str = "tassa", engine: str = "ad") -> Env:
    """Humanoid balance (reference res/humanoid.xml): nq 28, nv 27, nu 21,
    a free root and 21 hinges, 161 contact pairs, Euler at dt=0.005; N=30,
    5 iterations.  Value scaling keeps ||Vxx|| in range through the stiff
    contacts; reg_init=1e-2 because at N=30 the 1e-6 default rejects every
    linesearch candidate (the JAX package's measurements)."""
    model = _load("humanoid.xml")
    return Env(
        name="humanoid", model=model,
        cost_fn=humanoid_cost(model),
        ilqr=ILQRConfig(horizon=30, iterations=5, mode=mode,
                        value_scaling=True, reg_init=1e-2,
                        lin=LinearizeConfig(engine=engine)),
        warm_steps=0)


def tumbler_cost(qpos, qvel, ctrl):
    """Attitude hold and arm braking; the controllable terms dominate, since
    with no external torque the base turns only through the arm."""
    return (2.0 * (qpos[..., 4:7] ** 2).sum(-1)
            + 2.0 * (qpos[..., 7:] ** 2).sum(-1)
            + 0.2 * (qvel[..., 3:] ** 2).sum(-1)
            + 1e-2 * (ctrl ** 2).sum(-1))


def tumbler(mode: str = "tassa", engine: str = "ad") -> Env:
    """Floating-body attitude control: a free-joint capsule with a 2-dof
    arm driven by internal torques, no gravity, no contacts (nq 9, nv 8,
    nu 2, Euler at dt=0.01); N=20, 8 iterations."""
    return Env(
        name="tumbler", model=_load("tumbler.xml"), cost_fn=tumbler_cost,
        ilqr=ILQRConfig(horizon=20, iterations=8, mode=mode,
                        lin=LinearizeConfig(engine=engine)),
        warm_steps=0)


REGISTRY = {"pendulum": pendulum, "hopper": hopper, "humanoid": humanoid,
            "tumbler": tumbler}


def _load(asset: str) -> Model:
    if asset not in _CACHE:
        _CACHE[asset] = mjcf.load_model(str(ASSETS / asset))
    return _CACHE[asset]


def make(name: str, **kw) -> Env:
    """The env ``name``; an unknown name raises ``KeyError``."""
    return REGISTRY[name](**kw)
