"""PyTorch port, the spans and counters of ``utils/profiling.py`` inside the
solve loop: with tracing off a span is one shared object that allocates
and records nothing; with it on, the phases nest as the solve runs them,
each solve has its own request id, the constraint solver counts its
iterations and its host round trips, the spans lie on the clock of
``torch.profiler``'s events, and the card's idle time is charged to the
span the host was in.  CPU cases at a horizon of 5 and B=2; the ``cuda``
cases skip without a card, and on the card

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest

runs them alone."""

import dataclasses
import json
import time
import tracemalloc

import pytest
import torch

from ilqg_mujoco_torch import ilqr, mpc
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops import linalg
from ilqg_mujoco_torch.parallel import batch
from ilqg_mujoco_torch.physics import solver
from ilqg_mujoco_torch.utils import profiling


def _env(iterations=1):
    """The cart-pole's compat + FD solve (CG early exit at 1e-8 in the
    rollouts, pinned at 30 in the linearizer), cut to 5 knots."""
    env = envs.pendulum()
    return dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, horizon=5, iterations=iterations))


def _solves(env, n, device="cpu"):
    """The exported spans and the counters of ``n`` solves at B=2."""
    s, sol = batch.init_batched(env, 2, device=device)
    with profiling.tracing() as store:
        for _ in range(n):
            sol, _ = ilqr.solve(env.model, env.cost_fn, s, sol, env.ilqr)
        return store.export(), store.counters()


def test_off_is_one_shared_object_that_records_nothing(monkeypatch):
    assert profiling.span("x") is profiling._OFF
    assert profiling.span("y", device=True, request=True) is profiling._OFF
    assert profiling.count("z", 3) is None

    def refuse(*a, **k):
        raise AssertionError("recorded with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling.SpanStore, "open", refuse)
    monkeypatch.setattr(profiling.SpanStore, "add", refuse)
    env = _env()
    s, sol = batch.init_batched(env, 2, device="cpu")
    ilqr.iterate_compat(env.model, env.cost_fn, s, sol, env.ilqr)
    assert profiling._STORE is None


def test_off_allocates_nothing():
    for _ in range(10):           # warm the interpreter's caches
        with profiling.span("a", device=True):
            profiling.count("n")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("a", device=True):
                profiling.count("n")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno")
    assert sum(max(d.size_diff, 0) for d in grown) == 0


def test_tracing_nests_clears_and_ends():
    with profiling.tracing() as outer:
        with profiling.tracing() as inner:
            assert inner is outer
        assert profiling._STORE is outer
        with profiling.span("a"):
            profiling.count("n")
            outer.clear()
            with profiling.span("b"):
                profiling.count("n", 2)
        assert [s["path"] for s in outer.export()] == ["a/b"]
        assert outer.counters() == {"n": 2}
    assert profiling._STORE is None


def test_compat_iteration_nests_its_phases_one_request_a_solve():
    spans, counters = _solves(_env(), 2)
    paths = {s["path"] for s in spans}
    for phase in ("forward", "linearize", "backward"):
        assert f"solve/iteration/{phase}" in paths
    assert "solve/iteration/forward/cg" in paths
    assert "solve/iteration/linearize/cg" in paths
    assert "solve/iteration/forward/cg/cg.sync" in paths
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["solve", "solve"]
    assert [s["request"] for s in roots] == [1, 2]
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        root = s
        while root["parent"] is not None:
            root = by_id[root["parent"]]
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"]
        assert s["request"] == root["request"]
    assert counters["cg.iters"] == sum(s["counts"].get("cg.iters", 0)
                                       for s in spans)


def test_cg_counts_iterations_and_host_tests():
    spans, _ = _solves(_env(), 1)
    pinned = [s for s in spans if s["path"].endswith("linearize/cg")]
    early = [s for s in spans if s["path"].endswith("forward/cg")]
    assert pinned and early
    for s in pinned:
        assert s["counts"] == {"cg.iters": 30, "cg.syncs": 0}
    for s in early:
        n = s["counts"]["cg.iters"]
        assert 1 <= n < 100 and s["counts"]["cg.syncs"] == n + 1
        syncs = [c for c in spans if c["parent"] == s["id"]]
        assert {c["name"] for c in syncs} == {"cg.sync"}
        assert len(syncs) == n + 1


def test_cg_stopped_at_its_cap_tests_once_an_iteration():
    """An early-exit solve cut at 2 iterations, short of converging (3
    dofs, 4 rows all active): the host tested twice, once before each
    iteration."""
    gen = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=gen,
                                   dtype=torch.float64)
    A = r(2, 3, 3)
    M = A @ A.transpose(-1, -2) + 3.0 * torch.eye(3, dtype=torch.float64)
    D = torch.full((2, 4), 10.0, dtype=torch.float64)
    aref = torch.full((2, 4), 5.0, dtype=torch.float64)
    zero = torch.zeros((2, 3), dtype=torch.float64)
    with profiling.tracing() as store:
        _, niter = solver._solve_cg(M, linalg.cholesky(M), zero, r(2, 4, 3),
                                    D, aref, zero, 2, 1e-30, 8)
    assert niter.tolist() == [2, 2]
    assert store.counters() == {"cg.iters": 2, "cg.syncs": 2}


def test_mpc_frame_holds_its_solve_and_env_step():
    env = _env()
    s, sol = mpc.init(env, device="cpu")
    with profiling.tracing() as store:
        mpc.mpc_step(env, s, sol)
        paths = [x["path"] for x in store.export()]
    assert paths[0] == "frame"
    assert {"frame/solve", "frame/solve/iteration", "frame/env_step"} \
        <= set(paths)


def test_span_lies_on_the_profiler_clock():
    """A span around a 20 ms sleep agrees with its own ``record_function``
    event, in one profiler session, to within 1 ms at both ends."""
    from torch.profiler import ProfilerActivity, profile
    with profiling.tracing() as store, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("warm"):
            pass
        with profiling.span("sleep20"):
            time.sleep(0.02)
    span = next(s for s in store.export() if s["name"] == "sleep20")
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "sleep20"]
    assert len(evs) == 1
    start, end = evs[0].start_ns(), evs[0].start_ns() + evs[0].duration_ns()
    assert abs(start - span["start_ns"]) < 1e6
    assert abs(end - span["end_ns"]) < 1e6
    assert span["end_ns"] - span["start_ns"] >= 2e7


def test_trace_writes_span_names(tmp_path):
    with profiling.trace(tmp_path / "tr"):
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(8).sum()
                profiling.count("k", 2)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert {"outer", "inner"} <= {e.get("name")
                                  for e in events["traceEvents"]}
    rec = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert rec["spans"]["outer/inner"]["n"] == 1
    assert rec["counters"] == {"k": 2}


def test_idle_charged_to_the_innermost_span():
    """Spans A [0, 100] holding A/B [10, 40] and A/C [50, 90]; operations
    at [0, 5], [20, 30], [70, 95]; the window [0, 120]."""
    spans = [{"path": "A", "start_ns": 0, "end_ns": 100},
             {"path": "A/B", "start_ns": 10, "end_ns": 40},
             {"path": "A/C", "start_ns": 50, "end_ns": 90}]
    assert profiling.innermost(spans) == [
        (0, 10, "A"), (10, 40, "A/B"), (40, 50, "A"), (50, 90, "A/C"),
        (90, 100, "A")]
    ops = [("k1", 0, 5), ("k2", 20, 30), ("k3", 70, 95)]
    idle, gaps = profiling.idle_by_span(ops, spans, 0, 120)
    assert idle == {"A": 20, "A/B": 20, "A/C": 20, None: 20}
    assert gaps == [(40, "A/C", "k2"), (15, "A/B", "k1")]


def test_device_ops_leave_out_the_spans_ranges():
    """The card's kernels and copies, sorted by start; a span's range
    copied to the card's timeline is not one of them."""
    class Event:
        def __init__(self, name, device, start, dur):
            self.args = (name, device, start, dur)

        def name(self):
            return self.args[0]

        def device_type(self):
            return self.args[1]

        def start_ns(self):
            return self.args[2]

        def duration_ns(self):
            return self.args[3]

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [Event("k2", cuda, 30, 5), Event("forward", cuda, 0, 40),
              Event("Memcpy DtoH", cuda, 10, 2), Event("aten::add", cpu, 0, 1),
              Event("forward", cpu, 0, 40)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    assert profiling.device_ops(Prof, {"forward"}) == [
        ("Memcpy DtoH", 10, 12), ("k2", 30, 35)]
    assert len(profiling.device_ops(Prof)) == 3


@pytest.mark.cuda
def test_cg_iters_equal_graph_replays_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = _env(iterations=2)
    s, sol = batch.init_batched(env, 2, device="cuda")
    ilqr.solve(env.model, env.cost_fn, s, sol, env.ilqr)     # captures
    before = sum(solver._GRAPHS.replays.values())
    with profiling.tracing("cuda") as store:
        ilqr.solve(env.model, env.cost_fn, s, sol, env.ilqr)
        counters = store.counters()
    assert counters["cg.iters"] == sum(solver._GRAPHS.replays.values()) \
        - before
    assert "cg.captures" not in counters


@pytest.mark.cuda
def test_kernel_inside_its_span_on_the_profiler_clock():
    """A kernel made ~20 ms long by ``torch.cuda._sleep`` lies inside its
    span's host interval, to 0.5 ms, on the profiler's timeline, and the
    span's events time it on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile
    cycles = 40_000_000           # ~20 ms at the H100's 1.98 GHz
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profiling.tracing("cuda") as store, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span("sleepy", device=True):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
    span = next(s for s in store.export() if s["name"] == "sleepy")
    long = [op for op in profiling.device_ops(prof, {"sleepy"})
            if op[2] - op[1] > 5e6]
    assert len(long) == 1
    _, start, end = long[0]
    assert start >= span["start_ns"] - 5e5 and end <= span["end_ns"] + 5e5
    assert abs(span["device_ms"] - (end - start) / 1e6) < 0.5
