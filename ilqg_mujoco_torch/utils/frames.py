"""Advance the simulation by a step or a display frame: the port of
``ilqg_mujoco_tpu/utils/frames.py``, the reference's update layer
(reference src/update.cpp: ``forwardStep``, ``forwardFrame``)."""

from __future__ import annotations

from ..physics import forward as fwd
from ..physics.model import Model, State

FPS = 60.0   # reference src/update.cpp:5


def forward_step(model: Model, state: State) -> State:
    """forwardStep: one mj_step (reference src/update.cpp:8-11)."""
    return fwd.step(model, state)


def steps_per_frame(model: Model, fps: float = FPS) -> int:
    """max(1, round(1 / fps / timestep)): 8 on the hopper, 1 on the
    cart-pole at 60 fps."""
    return max(1, int(round(1.0 / fps / model.opt.timestep)))


def forward_frame(model: Model, state: State, fps: float = FPS) -> State:
    """forwardFrame: step until 1/fps simulated seconds have passed
    (reference src/update.cpp:14-20), a fixed number of steps since the
    timestep is a model constant."""
    for _ in range(steps_per_frame(model, fps)):
        state = fwd.step(model, state)
    return state
