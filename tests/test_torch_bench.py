"""The port's bench (``python -m ilqg_mujoco_torch.bench``) against the
JAX package's ``bench.py``, on the CPU.

- The estimator: ``bench.measure`` and the port's ``measure`` drive the
  same fake solve under one scripted clock (each solve call advances it by
  a scripted duration, in 1/64 s steps, so every chain time is exact), and
  the port's ``estimate`` takes the same chain times.  Rate and spread
  agree at rtol 1e-12, in the minima-differenced case and in the fallback
  where the minima's difference is not positive.
- The line: both mains, with ``build`` and ``measure`` replaced by stubs
  that return the same rate, print the same keys and values for every
  (env, mode, engine) of the registry, ``vs_baseline`` included; the port
  leaves out ``chunk_knots`` and adds ``device`` and ``dtype``.
- Backoff: an out-of-memory error at B retries at B/2 after
  ``solver.clear_graphs``; any other error propagates; a run where no
  batch fits prints the zero line and returns 1.
- One real run: the cart-pole compat+fd at B=2, REPS=2, TRIALS=1, its
  solver cut to N=6 and 3 iterations.

``bench.py`` switches on JAX's persistent compilation cache when it is
imported; the fixture switches it off again before anything compiles,
since this process's tests compile fresh.
"""

import dataclasses
import importlib.util
import json
import pathlib
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqg_mujoco_torch import bench
from ilqg_mujoco_torch.kernels import riccati
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.physics import solver
from ilqg_mujoco_tpu.models import envs as jenvs

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-12
MODES = ("tassa", "compat")
ENGINES = ("ad", "fd", "exact")
KNOBS = ("ILQG_BENCH_ENV", "ILQG_BENCH_MODE", "ILQG_BENCH_ENGINE",
         "ILQG_BENCH_BATCH", "ILQG_BENCH_REPS", "ILQG_BENCH_TRIALS",
         "ILQG_BENCH_BACKOFF", "ILQG_BENCH_CHUNK", "ILQG_BENCH_DTYPE")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The solves here are at B=2, too small for torch's intra-op threads,
    which only add CPU time beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jbench():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


class ScriptedClock:
    """``time.perf_counter`` that moves only when a fake solve runs."""

    def __init__(self):
        self.now = 1024.0

    def __call__(self):
        return self.now


def fake_solve(clock, durations):
    """A solve that takes the next scripted duration and returns numpy
    traces; it records every call's duration."""
    it = iter(durations)
    calls = []

    def solve(states, sols):
        d = next(it)
        calls.append(d)
        clock.now += d
        return sols, np.ones((2, 3))
    return solve, calls


def chain_times(durations, reps, trials):
    """The chains' seconds as both benches cut the calls: a warm call,
    then per trial a chain of max(reps // 2, 1) and one of reps."""
    half = max(reps // 2, 1)
    i, th, tf = 1, [], []
    for _ in range(trials):
        th.append(sum(durations[i:i + half]))
        i += half
        tf.append(sum(durations[i:i + reps]))
        i += reps
    return th, tf


def assert_same_estimate(got, want):
    (rate, spread), (rate_w, spread_w) = got, want
    np.testing.assert_allclose(rate, rate_w, rtol=RTOL)
    assert spread.keys() == spread_w.keys()
    for k in spread:
        if isinstance(spread[k], str):
            assert spread[k] == spread_w[k]
        else:
            np.testing.assert_allclose(spread[k], spread_w[k], rtol=RTOL)


def _durations(case):
    """(reps, trials, durations of every call, warm call first)."""
    rng = np.random.default_rng(7)
    if case == "minima":
        reps, trials = 4, 3
        d = list(rng.integers(8, 40, 1 + trials * 6) / 64.0)
        d[2] += 3.0                 # a stall inside one short chain
    elif case == "fallback":
        # every long chain is quicker than every short one: the minima's
        # difference is negative and each trial's too
        reps, trials = 4, 2
        d = [1.0] + [2.0, 2.0, 0.25, 0.25, 0.25, 0.25] * trials
    else:                           # odd reps, one chain of 1 and one of 3
        reps, trials = 3, 2
        d = list(rng.integers(8, 40, 1 + trials * 4) / 64.0)
    return reps, trials, d


@pytest.mark.parametrize("case", ["minima", "fallback", "odd_reps"])
def test_estimator_matches_bench_py(jbench, monkeypatch, case):
    reps, trials, d = _durations(case)
    clock = ScriptedClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    env = types.SimpleNamespace(ilqr=types.SimpleNamespace(iterations=10,
                                                           mode="tassa"))
    B = 64
    # warm bench.py's value fetch, so that its first call compiles nothing
    # while the clock is scripted
    float(jnp.sum(np.ones((2, 3))))
    solve, calls = fake_solve(clock, d)
    want = jbench.measure(env, None, None, solve, B, reps, trials)
    assert calls == d
    solve, calls = fake_solve(clock, d)
    got = bench.measure(env, None, None, solve, B, reps, trials, "cpu")
    assert calls == d
    assert_same_estimate(got, want)
    th, tf = chain_times(d, reps, trials)
    assert_same_estimate(bench.estimate(th, tf, B * 10, reps), want)
    if case == "fallback":
        assert min(tf) < min(th)
        np.testing.assert_allclose(want[0], B * 10 * reps / min(tf),
                                   rtol=RTOL)


def _run_main(main, capsys):
    rc = main()
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(jenvs.REGISTRY))
def test_line_matches_bench_py(jbench, monkeypatch, capsys, name, mode,
                               engine):
    rate = 1234.56789 + 17.0 * len(name + mode + engine)
    spread = {"min": 1.0, "median": 2.0, "max": 3.0, "trials": 3,
              "estimator": "minima-differenced"}
    monkeypatch.setenv("ILQG_BENCH_ENV", name)
    monkeypatch.setenv("ILQG_BENCH_MODE", mode)
    monkeypatch.setenv("ILQG_BENCH_ENGINE", engine)
    stub_build = lambda *a, **k: (None,) * 4
    stub_measure = lambda *a, **k: (rate, dict(spread))
    for mod in (jbench, bench):
        monkeypatch.setattr(mod, "build", stub_build)
        monkeypatch.setattr(mod, "measure", stub_measure)
    rc_w, want = _run_main(jbench.main, capsys)
    rc, got = _run_main(lambda: bench.main(device="cpu"), capsys)
    assert rc == rc_w == 0
    del want["chunk_knots"]
    assert got.pop("device") == "cpu"
    assert got.pop("dtype") == "float64"
    assert got == want
    if name in ("pendulum", "hopper"):
        assert got["vs_baseline"] > 0
    else:
        assert got["vs_baseline"] is None


def _oom(msg="CUDA out of memory"):
    return torch.cuda.OutOfMemoryError(msg)


@pytest.fixture
def cleared(monkeypatch):
    calls = []
    monkeypatch.setattr(solver, "clear_graphs", lambda: calls.append(1))
    return calls


def test_backoff_halves_after_oom(monkeypatch, capsys, cleared):
    tried = []

    def attempt(env_name, mode, engine, batch, *rest):
        tried.append(batch)
        if batch > 2048:
            raise _oom()
        return 99.0, {"trials": 1}
    monkeypatch.setattr(bench, "_attempt", attempt)
    rc, line = _run_main(lambda: bench.main(device="cpu"), capsys)
    assert rc == 0 and tried == [4096, 2048] and len(cleared) == 1
    assert line["batch"] == 2048
    assert line["metric"] == "ilqr_iters_per_s_pendulum_batch2048"
    assert len(line["backoff_from"]) == 1
    assert line["backoff_from"][0].startswith("B=4096: OutOfMemoryError")


def test_other_errors_propagate(monkeypatch, cleared):
    def attempt(*args):
        raise RuntimeError("the kernel failed to launch")
    monkeypatch.setattr(bench, "_attempt", attempt)
    with pytest.raises(RuntimeError, match="failed to launch"):
        bench.main(device="cpu")
    assert not cleared


@pytest.mark.parametrize("backoff", ["1", "0"])
def test_no_batch_fits(monkeypatch, capsys, cleared, backoff):
    tried = []

    def attempt(env_name, mode, engine, batch, *rest):
        tried.append(batch)
        raise _oom()
    monkeypatch.setattr(bench, "_attempt", attempt)
    monkeypatch.setenv("ILQG_BENCH_ENV", "hopper")
    monkeypatch.setenv("ILQG_BENCH_BACKOFF", backoff)
    rc, line = _run_main(lambda: bench.main(device="cpu"), capsys)
    want = [1024, 512, 256, 128, 64] if backoff == "1" else [1024]
    assert rc == 1 and tried == want and len(cleared) == len(want)
    assert line["value"] == 0 and line["vs_baseline"] is None
    assert line["metric"] == "ilqr_iters_per_s_hopper"
    assert len(line["errors"]) == len(want)


def test_real_run_cartpole_compat(monkeypatch, capsys):
    for k, v in (("ILQG_BENCH_MODE", "compat"), ("ILQG_BENCH_ENGINE", "fd"),
                 ("ILQG_BENCH_BATCH", "2"), ("ILQG_BENCH_REPS", "2"),
                 ("ILQG_BENCH_TRIALS", "1")):
        monkeypatch.setenv(k, v)
    make = envs.make

    def cut(*a, **kw):
        env = make(*a, **kw)
        return dataclasses.replace(env, ilqr=dataclasses.replace(
            env.ilqr, horizon=6, iterations=3))
    monkeypatch.setattr(envs, "make", cut)
    before = riccati.LAUNCHES
    rc, line = _run_main(lambda: bench.main(device="cpu"), capsys)
    assert rc == 0 and riccati.LAUNCHES == before     # the plain version
    assert sorted(line) == sorted(
        ["metric", "value", "unit", "vs_baseline", "spread", "batch",
         "device", "dtype"])
    assert line["metric"] == "ilqr_iters_per_s_pendulum_batch2_compat_fd"
    assert line["value"] > 0 and line["batch"] == 2
    ref = json.loads((ROOT / "baselines.json").read_text())["pendulum"]
    assert abs(line["vs_baseline"] - line["value"]
               / ref["ilqr_iters_per_s"]) <= 0.01
    assert line["spread"]["trials"] == 1
    assert line["spread"]["estimator"] == "minima-differenced"
    assert (line["device"], line["dtype"]) == ("cpu", "float64")
