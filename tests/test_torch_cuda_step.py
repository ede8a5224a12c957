"""PyTorch port, the physics step as CUDA graphs cut at its constraint
solves (``physics/stepgraph.py``) on the card.  The graphed step gives the
eager step's bits over 20 steps (the cart-pole at B=1 and 4,096, the
hopper in contact at 1,024, the humanoid in contact at 112); evicting the
direct solves' CG steps (their LRU cut to one) and ``solver.clear_graphs``
between steps leave those bits as they are; the counters add up: one
capture a shape, and ``step.graphed + step.eager`` the steps taken; and
with two cards a step on the second gives the first's bits.  Skips
without a card; on the card, where
JAX may be missing,

    python -m pytest tests/test_torch_cuda_step.py -m cuda --noconftest

runs it alone."""

import dataclasses

import pytest
import torch

from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics import solver, stepgraph
from ilqg_mujoco_torch.physics.model import State, make_state
from ilqg_mujoco_torch.utils import profiling

FIELDS = [f.name for f in dataclasses.fields(State)]


def _states(name, batch, seed=0):
    """``batch`` instances off qpos0 on the card: the cart-pole's pole
    swung and the cart pushed to its limits, the hopper and the humanoid
    lowered into the floor."""
    m = envs.make(name).model
    g = torch.Generator().manual_seed(seed)
    s = make_state(m, batch, device="cpu")
    rand = lambda t: torch.randn(t.shape, generator=g, dtype=t.dtype)
    qpos = s.qpos + 0.05 * rand(s.qpos)
    if name == "pendulum":
        qpos[:, 0] = 1.1 * torch.sin(torch.arange(batch, dtype=qpos.dtype))
        qpos[:, 1] += torch.linspace(-1.5, 1.5, batch, dtype=qpos.dtype)
    elif name == "hopper":
        qpos[:, 1] -= 0.1
    else:
        qpos[:, 2] -= 0.13
    s = s.replace(qpos=qpos, qvel=0.5 * rand(s.qvel),
                  ctrl=0.3 * rand(s.ctrl))
    return m, s.map(lambda t: t.cuda())


def _eager(m, s):
    return solver.drive(fwd.step_gen(m, s))


def _equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", [("pendulum", 1), ("pendulum", 4096),
                                        ("hopper", 1024), ("humanoid", 112)],
                         ids=["cartpole-b1", "cartpole-b4096", "hopper-b1024",
                              "humanoid-b112"])
def test_graphed_step_matches_eager(name, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    solver.clear_graphs()
    m, s = _states(name, batch)
    graphed = eager = s
    with profiling.tracing() as store:
        for _ in range(20):
            graphed = fwd.step(m, graphed)
            eager = _eager(m, eager)
            _equal(graphed, eager)
        counters = store.counters()
    assert counters["step.captures"] == 1
    assert counters["step.eager"] == 1 and counters["step.graphed"] == 19
    assert len(stepgraph._STEPS) == 1
    assert not torch.equal(graphed.qpos, s.qpos)
    solver.clear_graphs()


@pytest.mark.cuda
def test_eviction_and_clear_keep_the_bits(monkeypatch):
    """Two shapes in turns, their eager references' solves through a CG
    cache of one step, so each of those evicts the other shape's CG step
    (the graphed steps own theirs), and ``clear_graphs`` after step 8:
    every step gives the eager bits, and the counters add up."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    solver.clear_graphs()
    monkeypatch.setattr(solver._GRAPHS, "size", 1)
    m, s = _states("pendulum", 64)
    runs = {64: (s, s), 16: (s.map(lambda t: t[:16]),) * 2}
    steps = 0
    with profiling.tracing() as store:
        for i in range(20):
            for n, (graphed, eager) in runs.items():
                graphed = fwd.step(m, graphed)
                eager = _eager(m, eager)
                _equal(graphed, eager)
                runs[n] = (graphed, eager)
                steps += 1
                assert len(solver._GRAPHS.steps) <= 1
            if i == 8:
                solver.clear_graphs()
                assert not stepgraph._STEPS and not solver._GRAPHS.steps
        counters = store.counters()
    # each shape warms up and captures twice: before and after the clear
    assert counters["step.captures"] == 4 and counters["step.eager"] == 4
    assert counters["step.graphed"] + counters["step.eager"] == steps
    solver.clear_graphs()


@pytest.mark.cuda
def test_graphed_step_on_a_second_card():
    """The humanoid's step on cuda:1 while cuda:0 is current captures and
    replays its segments on cuda:1: every step gives the eager step's bits
    there, and the last the bits of the same steps on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    solver.clear_graphs()
    m, s = _states("humanoid", 16)
    last = {}
    with torch.cuda.device(0):
        for dev in ("cuda:0", "cuda:1"):
            graphed = eager = s.map(lambda t: t.to(dev))
            for _ in range(5):
                graphed = fwd.step(m, graphed)
                eager = _eager(m, eager)
                _equal(graphed, eager)
            last[dev] = graphed.map(lambda t: t.cpu())
        assert graphed.qpos.device == torch.device("cuda:1")
    assert len(stepgraph._STEPS) == 2
    _equal(last["cuda:1"], last["cuda:0"])
    solver.clear_graphs()
