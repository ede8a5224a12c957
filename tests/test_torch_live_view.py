"""The port's live solve/render loop (``ilqg_mujoco_torch/live_view.py``),
the counterpart of tests/test_live_view.py at a CPU-sized configuration
(10 frames, horizon 8, 2 iterations): headless it keeps the pole upright,
its history is exactly ``mpc.run``'s trajectory for the same
configuration, and it honours the viewer's ``is_running``."""

import dataclasses

import numpy as np
import pytest

from ilqg_mujoco_torch import live_view, mpc
from ilqg_mujoco_torch.models import envs

FRAMES, HORIZON, ITERS = 10, 8, 2


@pytest.fixture(scope="module")
def headless():
    return live_view.live_loop("pendulum", frames=FRAMES, fps=0.0,
                               headless=True, horizon=HORIZON,
                               iterations=ITERS, device="cpu")


def test_live_loop_headless_balances(headless):
    hist, seconds = headless
    assert hist.shape == (FRAMES, 2)
    assert np.all(np.isfinite(hist))
    assert np.abs(hist[:, 1]).max() < 0.1     # pole stays upright
    assert len(seconds) == FRAMES and min(seconds) > 0.0


def test_live_loop_equals_mpc_run(headless):
    """Frame i shows the state after i + 1 MPC steps: mpc.run's states
    1..FRAMES-1 and its final state, bit for bit."""
    env = envs.pendulum()
    env = dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, horizon=HORIZON, iterations=ITERS))
    out = mpc.run(env, FRAMES, device="cpu")
    want = np.concatenate([out.env_states.qpos[0, 1:].numpy(),
                           out.final_state.qpos.numpy()])
    np.testing.assert_array_equal(headless[0], want)


def test_live_loop_early_exit(monkeypatch):
    """The loop honours the viewer's is_running() (window close)."""
    class TwoFrames(live_view._NullViewer):
        def __init__(self):
            self.n = 0

        def is_running(self):
            self.n += 1
            return self.n <= 2

    monkeypatch.setattr(live_view, "_make_viewer",
                        lambda *a: (TwoFrames(), None, None))
    hist, seconds = live_view.live_loop(
        "pendulum", frames=40, fps=0.0, headless=False, horizon=HORIZON,
        iterations=ITERS, device="cpu")
    assert len(hist) == 2 and len(seconds) == 2
