"""PyTorch port, the physics step cut at its constraint solves
(``physics/stepgraph.py``), on the CPU.

* The split constraint solve (``solver.cg_prologue``, ``cg_loop``,
  ``finish``), with its carry in static buffers as a captured step holds
  it, gives the bits of the port's own ``solver._solve_cg`` and
  ``solver.solve`` and of the frozen eager solver, pinned and early
  exit, on the cart-pole's limit rows and the humanoid's contacts.
* The step driven segment by segment (``stepgraph.cut_solve``, each CG
  loop between two segments) gives the bits of the frozen eager
  ``fwd.step`` over 20 steps: the cart-pole (RK4, four cuts a step), the
  hopper and the humanoid (Euler, contacts, one cut) and the tumbler (no
  rows, no cut).  The port's own eager step is the same pipeline run
  with ``solver.solve``; the card tests compare the graphed step with
  it.
* The eligibility rule keeps a step eager for CPU tensors, forward-AD
  duals, a state that records gradients and an active dispatch mode.

The frozen solver and step are ``benchmark/reference``: a copy of the
port's physics taken before the step was written as a pipeline of
generators, which decides the benchmark's ``correct`` and so does not
follow the port's changes.  Against it these tests show that rewriting
the pipeline kept every bit.  A change to ``benchmark/reference`` has to
keep these bits, or these tests have to compare with the port's own
eager path alone, as the split solve's test does too.

The card's own cases are in ``tests/test_torch_cuda_step.py``."""

import dataclasses

import pytest
import torch
from torch.autograd import forward_ad as fwAD
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference import forward as ref_fwd
from benchmark.reference import mjcf as ref_mjcf
from benchmark.reference import model as ref_model
from benchmark.reference import solver as ref_solver
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops import linalg
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics import solver, stepgraph
from ilqg_mujoco_torch.physics.model import State, make_state
from ilqg_mujoco_torch.utils import profiling

ASSET = {"pendulum": "cartpole.xml", "humanoid": "humanoid.xml",
         "hopper": "hopper.xml", "tumbler": "tumbler.xml"}
FIELDS = [f.name for f in dataclasses.fields(State)]


class CpuStep:
    """A captured CG step's interface on the CPU: static buffers for ``c``
    and the carry, and a "replay" that runs one iteration into them."""

    def __init__(self, c, carry, tolerance, ls_iterations):
        self.key = solver.graph_key(c, carry, tolerance, ls_iterations)
        self.c = tuple(torch.empty_like(t) for t in c)
        self.carry = tuple(torch.empty_like(t) for t in carry)
        self.args = (tolerance, ls_iterations)
        self.load(c, carry)

    def load(self, c, carry):
        for dst, src in zip(self.c + self.carry, tuple(c) + tuple(carry)):
            dst.copy_(src)

    def replay(self):
        solver.step_into(self.c, self.carry, *self.args)


def _state(name, batch=2):
    """``batch`` instances off qpos0: the cart against its limits, the
    hopper and the humanoid lowered into the floor, the tumbler turned."""
    m = envs.make(name).model
    g = torch.Generator().manual_seed(7)
    s = make_state(m, batch, device="cpu")
    noise = lambda t, a: t + a * torch.randn(t.shape, generator=g,
                                             dtype=t.dtype)
    qpos = noise(s.qpos, 0.05)
    if name == "pendulum":
        qpos[:, 0] = torch.tensor([1.02, -1.01])[:batch]
    if name == "humanoid":
        qpos[:, 2] -= 0.13
    if name == "hopper":
        qpos[:, 1] -= 0.1
    return m, s.replace(qpos=qpos, qvel=noise(s.qvel, 0.5),
                        ctrl=noise(s.ctrl, 0.3))


def _ref_step(name, state):
    rm = _ref_models.setdefault(
        name, ref_mjcf.load_model(str(envs.ASSETS / ASSET[name])))
    out = ref_fwd.step(rm, ref_model.State(**{f: getattr(state, f)
                                              for f in FIELDS}))
    return State(**{f: getattr(out, f) for f in FIELDS})


_ref_models = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and tensors this small gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,tolerance", [
    ("pendulum", 0.0), ("pendulum", 1e-8), ("humanoid", 0.0),
    ("humanoid", 1e-8)],
    ids=["cartpole-pinned", "cartpole-early_exit", "humanoid-pinned",
         "humanoid-early_exit"])
def test_split_solve_matches_frozen_solver(name, tolerance):
    m, s = _state(name)
    _, aux = fwd.forward_full(m, s)
    efc = aux.efc
    assert int((efc.D > 0).sum()) >= 2      # rows in the solve
    c = (aux.kin.M, linalg.cholesky(aux.kin.M), aux.qacc_smooth, efc.J,
         efc.D, efc.aref)
    warm = s.qacc_warmstart + 0.1
    iterations = 30 if tolerance == 0.0 else 100
    ref_x, ref_n = ref_solver._solve_cg(*c, warm, iterations, tolerance, 16)
    ref = ref_solver.solve(c[0], c[1], c[2], efc, warm, iterations,
                           tolerance, 16)
    assert int(ref_n.max()) >= 2
    own = solver.solve(c[0], c[1], c[2], efc, warm, iterations, tolerance,
                       16)
    # the eager loop and the loop on static buffers, as a replay runs it
    split = solver.cg_loop(c, solver.cg_prologue(c, warm), iterations,
                           tolerance, 16)
    step = CpuStep(c, solver.cg_prologue(c, warm), tolerance, 16)
    solver.cg_loop(step.c, step.carry, iterations, tolerance, 16, step)
    for carry in (split, step.carry):
        out = solver.finish(efc, carry[0].clone(), carry[4].clone())
        assert torch.equal(out.qacc, ref_x) and torch.equal(out.qacc,
                                                            ref.qacc)
        assert torch.equal(carry[4], ref_n)
        assert torch.equal(out.qfrc_constraint, ref.qfrc_constraint)
        assert torch.equal(out.niter, ref.niter)
        for want in (own, ref):
            for got, exp in zip(out, want):
                assert torch.equal(got, exp)
    x, n = solver._solve_cg(*c, warm, iterations, tolerance, 16)
    assert torch.equal(x, ref_x) and torch.equal(n, ref_n)


@pytest.mark.parametrize("name,cuts", [("pendulum", 4), ("hopper", 1),
                                       ("humanoid", 1), ("tumbler", 0)],
                         ids=["cartpole-rk4", "hopper-euler",
                              "humanoid-euler", "tumbler"])
def test_segmented_step_matches_frozen_step(name, cuts):
    m, s = _state(name)
    ref = seg = s
    for _ in range(20):
        made = []

        def between(step, iterations, tolerance, ls_iterations):
            made.append(step)
            solver.cg_loop(step.c, step.carry, iterations, tolerance,
                           ls_iterations, step)

        seg = solver.drive(fwd.step_gen(m, seg),
                           stepgraph.cut_solve(CpuStep, between))
        assert len(made) == cuts
        ref = _ref_step(name, ref)
        for f in FIELDS:
            assert torch.equal(getattr(seg, f), getattr(ref, f)), f
    assert not torch.equal(seg.qpos, s.qpos)


class _Passthrough(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["cpu", "dual", "requires_grad",
                                  "dispatch_mode"])
def test_ineligible_steps_run_eagerly(case, monkeypatch):
    """Each input the rule refuses steps eagerly and captures nothing; off
    the CPU case the device test is waived, so the refusal is the case's
    own, and a plain state then passes the rule."""
    m, s = _state("pendulum", batch=1)
    if case != "cpu":
        monkeypatch.setattr(stepgraph, "_on_card", lambda ts: True)
    want = _ref_step("pendulum", s)
    with profiling.tracing() as store, fwAD.dual_level():
        if case == "dual":
            s = s.replace(ctrl=fwAD.make_dual(s.ctrl, torch.ones_like(
                s.ctrl)))
        if case == "requires_grad":
            s = s.replace(qvel=s.qvel.clone().requires_grad_())
        mode = _Passthrough() if case == "dispatch_mode" else None
        if mode is not None:
            mode.__enter__()
        try:
            assert not stepgraph.eligible(s)
            got = fwd.step(m, s)
        finally:
            if mode is not None:
                mode.__exit__(None, None, None)
        got = State(**{f: fwAD.unpack_dual(getattr(got, f)).primal.detach()
                       for f in FIELDS})
        counters = store.counters()
    assert counters["step.eager"] == 1
    assert "step.graphed" not in counters and not stepgraph._STEPS
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if case != "cpu":
        assert stepgraph.eligible(_state("pendulum", batch=1)[1])
