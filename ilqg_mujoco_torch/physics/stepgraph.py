"""``fwd.step`` on the card as a short, fixed sequence of CUDA graphs, cut
only where the host must look at the card: the early-exit loop of each
constraint solve.

An RK4 step (four solves) is five segments, an Euler step (one solve) two,
and a model without constraint rows one.  Between two segments the CG loop
runs as it does in ``solver._solve_cg``: its host test, then one replay of
its own captured iteration (``solver.cg_loop``), so every instance gets the
same iterates and the same iteration count.  A segment ends with the next
solve's prologue (``solver.cg_prologue``) and the copy of ``c`` and the
carry into that CG step's static buffers; the next segment starts with the
solve's epilogue (``solver.finish``) on the carry those buffers hold.  So
between segments the host only replays and tests.

The pipeline is ``forward.step_gen``, the generator the eager step runs
too (``solver.drive``); :func:`cut_solve` answers each solve it yields as
above.  Per shape (:class:`_Entry`, keyed by the model, the state's
shapes, dtypes and device, the iterations, the tolerance and the
integrator), the first call runs eagerly on the card's side stream
(``solver.side_stream``): the warm-up, which also learns the CG step each
solve writes into.  The second call captures segment by segment into the
entry's own memory pool, replaying each segment and running the CG loop
on real values before the next segment is captured.  Every later call
copies the state into the entry's static inputs, replays the segments in
capture order with the loops between them, and clones the static outputs.
The same kernels run on the same values as in the eager step, so the
results are its bits.

An entry captures and owns the CG steps it writes into (its own
``solver._GraphCache``, one step for each shape of solve in the step), so
``solver._GRAPHS`` serves ``solver._solve_cg`` alone and no eviction there
touches a segment's buffers.  The entries are a bounded LRU
(:data:`MAX_STEPS`), so at most that many steps' segments, pools and CG
steps are held; ``solver.clear_graphs`` empties it (:func:`clear`,
registered with ``solver.on_clear``).

Graphs engage only by what the input shows (:func:`eligible`): CUDA
tensors, no forward-AD tangents, no gradient recording and no active
``TorchDispatchMode`` (``tools/roofline`` counts every operation under
one).  Inside ``profiling.tracing`` each step counts ``step.graphed`` (the
capturing call too) or ``step.eager``, each capture ``step.captures``, and
a capture is the span ``step.capture``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch
from torch.autograd import forward_ad as fwAD
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..utils import profiling
from . import solver
from .model import State

_FIELDS = tuple(f.name for f in dataclasses.fields(State))

# the step shapes of one path: the forward pass or rollout and the MPC
# env step (one shape at B=1), tassa's alpha rollouts at 7B
MAX_STEPS = 4
# the solves of one step: RK4's four
_MAX_SOLVES = 4


def _on_card(ts) -> bool:
    return all(t.is_cuda for t in ts)


def eligible(state: State) -> bool:
    """Whether a step of ``state`` runs as graphs: its tensors are on the
    card, carry no forward-AD tangent, record no gradient, and no
    ``TorchDispatchMode`` is active."""
    ts = [getattr(state, f) for f in _FIELDS]
    return (_on_card(ts)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts))
            and all(fwAD.unpack_dual(t).tangent is None for t in ts)
            and _get_current_dispatch_mode() is None)


def cut_solve(get, between):
    """A ``solve`` for ``solver.drive`` that splits each solve with rows
    at its CG loop: the prologue, ``get(c, carry, tolerance,
    ls_iterations)`` (the CG step, loaded with them), ``between(step,
    iterations, tolerance, ls_iterations)`` (the loop, and the cut while
    capturing), and the epilogue on the step's carry.  A solve without
    rows has no loop and runs whole."""
    def solve(M, Mfac, qacc_smooth, efc, warmstart, iterations, tolerance,
              ls_iterations):
        if efc.J.shape[-2] == 0:
            return solver.solve(M, Mfac, qacc_smooth, efc, warmstart,
                                iterations, tolerance, ls_iterations)
        c = (M, Mfac, qacc_smooth, efc.J, efc.D, efc.aref)
        step = get(c, solver.cg_prologue(c, warmstart), tolerance,
                   ls_iterations)
        between(step, iterations, tolerance, ls_iterations)
        return solver.finish(efc, step.carry[0].clone(),
                             step.carry[4].clone())
    return solve


def _loop(step, iterations, tolerance, ls_iterations):
    with profiling.span("cg"):
        solver.cg_loop(step.c, step.carry, iterations, tolerance,
                       ls_iterations, step)


def _on_side(device, fn):
    """``fn()`` on the device's side stream (``solver.side_stream``, where
    the segments are captured), ordered after and before the current
    stream's work."""
    with torch.cuda.device(device):
        side = solver.side_stream(device)
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
    return out


class _Entry:
    """One shape's step: its own CG steps (``cg``), the CG step of each
    solve in order (``cuts``: (step, iterations, tolerance,
    ls_iterations)), and once captured its segments (in one memory pool of
    their own), the static input state and the static output state."""

    def __init__(self, device):
        self.device = device
        self.cg = solver._GraphCache(_MAX_SOLVES)
        self.cuts, self.graphs = [], None
        self.inp = self.out = None

    def warm(self, step_gen, state):
        """The eager step, capturing the CG step of each shape of solve and
        recording the one each solve uses."""
        def between(step, iterations, tolerance, ls_iterations):
            self.cuts.append((step, iterations, tolerance, ls_iterations))
            _loop(step, iterations, tolerance, ls_iterations)

        return _on_side(self.device, lambda: solver.drive(
            step_gen(state), cut_solve(self.cg.get, between)))

    def capture(self, step_gen, state):
        """Capture the segments, each replayed and followed by its CG loop
        on real values before the next is captured; returns the step."""
        pool = torch.cuda.graph_pool_handle()
        self.inp = state.map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                   device=t.device))
        graphs, cuts = [], iter(self.cuts)

        def begin():
            graphs.append(torch.cuda.CUDAGraph())
            graphs[-1].capture_begin(pool=pool)

        def end():
            graphs[-1].capture_end()
            graphs[-1].replay()

        def get(c, carry, tolerance, ls_iterations):
            step = next(cuts)[0]
            if solver.graph_key(c, carry, tolerance,
                                ls_iterations) != step.key:
                raise RuntimeError("a solve of the step being captured "
                                   "differs from its warm-up's")
            step.load(c, carry)
            return step

        def between(step, iterations, tolerance, ls_iterations):
            end()
            _loop(step, iterations, tolerance, ls_iterations)
            begin()

        def run():
            self._load(state)
            begin()
            try:
                out = solver.drive(step_gen(self.inp),
                                   cut_solve(get, between))
            except BaseException:
                if torch.cuda.is_current_stream_capturing():
                    try:        # the error that broke the capture is news
                        graphs[-1].capture_end()
                    except RuntimeError:
                        pass
                raise
            end()
            return out

        self.out = _on_side(self.device, run)
        self.graphs = graphs
        return self._emit(state)

    def replay(self, state):
        with torch.cuda.device(self.device):
            self._load(state)
            for graph, cut in zip(self.graphs, self.cuts + [None]):
                graph.replay()
                if cut is not None:
                    _loop(*cut)
        return self._emit(state)

    def _load(self, state):
        for f in _FIELDS:
            getattr(self.inp, f).copy_(getattr(state, f))

    def _emit(self, state):
        """The step's result: the static outputs cloned, and the fields it
        passes through (its own static inputs) as the caller gave them."""
        return State(**{f: getattr(state, f)
                        if getattr(self.out, f) is getattr(self.inp, f)
                        else getattr(self.out, f).clone() for f in _FIELDS})


_STEPS: OrderedDict = OrderedDict()


def step(model, state: State, iterations, tolerance, step_gen):
    """``step_gen(model, state, iterations, tolerance)`` (``forward.step_gen``)
    run for an :func:`eligible` state: eagerly at a shape's first call,
    captured at its second, replayed after."""
    ts = [getattr(state, f) for f in _FIELDS]
    key = (model, iterations, tolerance, model.opt.integrator,
           tuple((tuple(t.shape), t.dtype, t.device) for t in ts))
    gen = lambda s: step_gen(model, s, iterations, tolerance)
    entry = _STEPS.get(key)
    if entry is not None and entry.graphs is not None:
        _STEPS.move_to_end(key)
        profiling.count("step.graphed")
        return entry.replay(state)
    try:        # an entry half built is dropped
        if entry is None:
            while len(_STEPS) >= MAX_STEPS:
                _STEPS.popitem(last=False)
            entry = _STEPS[key] = _Entry(state.qpos.device)
            profiling.count("step.eager")
            return entry.warm(gen, state)
        _STEPS.move_to_end(key)
        with profiling.span("step.capture"):
            out = entry.capture(gen, state)
    except BaseException:
        _STEPS.pop(key, None)
        raise
    profiling.count("step.captures")
    profiling.count("step.graphed")
    return out


def clear() -> set:
    """Drop every held step; returns the devices they ran on."""
    devices = {e.device for e in _STEPS.values()}
    _STEPS.clear()
    return devices


solver.on_clear(clear)
