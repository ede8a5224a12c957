"""PyTorch port, the linearizer's knot chunking
(``LinearizeConfig.chunk_knots``) and the bench's chunk knob, on the CPU.

- The port's ``linearize_traj`` at ``chunk_knots=4`` against the JAX
  package's at ``chunk_knots=4`` on ``tests/test_torch_linearize.py``'s
  cart-pole fd trajectory (2 instances, 21 knots, so the last chunk is
  padded), at that file's tolerance: rtol 1e-6, atol 1e-8 (cost 1e-12).
- Chunked against unchunked in the port for c in (3, 2, 7, 10), on knots
  made distinct as in ``tests/test_linearize.py``: the fd engine on the
  cart-pole at T=7 (padded tails, c = T, c > T), the ad engine on the
  hopper at B=2, T=6 with its foot in the ground (contacts through the
  solver's JVP; exact fits, c > T) and the exact engine on the tumbler's
  quaternion states at T=5; rtol 1e-7, atol 1e-9, the JAX test's.
- A cart-pole compat+fd ``ilqr.solve`` at B=2 (N=10, 3 iterations) with
  ``chunk_knots=8`` against the unchunked solve: traces within 1e-9
  relative, gains within ``tests/test_golden_compat.py``'s tolerances.
- The bench: ``auto_chunk`` keeps every default batch unchunked, the line
  prints the chunk that ``build`` was given (``auto_chunk``'s, or
  ``ILQG_BENCH_CHUNK``'s), the backoff picks it again at each batch, and
  ``build`` sets the env's ``chunk_knots``.  ``bsweep``'s rows and
  ``roofline`` hand the chunk on (the process and ``bench.build``
  stubbed), and a row reads the CG graph cache's static bytes that the
  bench reports (``solver._GraphCache.static_bytes``).
"""

import dataclasses
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqg_mujoco_tpu.models import envs as jenvs
from ilqg_mujoco_tpu.ops.linearize import LinearizeConfig as JLinCfg
from ilqg_mujoco_tpu.ops.linearize import linearize_traj as jlinearize_traj
from ilqg_mujoco_tpu.physics.model import State as JState
from ilqg_mujoco_torch import bench, ilqr
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops.linearize import (LinearizeConfig, LinOut,
                                             linearize_traj)
from ilqg_mujoco_torch.parallel import batch as pbatch
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics import solver
from ilqg_mujoco_torch.physics.model import make_state
from ilqg_mujoco_torch.tools import bsweep, roofline
from ilqg_mujoco_torch.utils.convert import to_numpy

CPU = torch.device("cpu")
KNOBS = ("ILQG_BENCH_ENV", "ILQG_BENCH_MODE", "ILQG_BENCH_ENGINE",
         "ILQG_BENCH_BATCH", "ILQG_BENCH_REPS", "ILQG_BENCH_TRIALS",
         "ILQG_BENCH_BACKOFF", "ILQG_BENCH_CHUNK", "ILQG_BENCH_DTYPE")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The passes here are at B <= 2, too small for torch's intra-op
    threads, which only add CPU time beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def with_chunk(cfg, c):
    return dataclasses.replace(cfg, chunk_knots=c)


def test_chunked_matches_jax_chunked():
    """``tests/test_torch_linearize.py``'s trajectory: two instances rolled
    out 20 steps, the second against both joint limits."""
    env = envs.pendulum()
    s = make_state(env.model, 2, device="cpu").replace(
        qpos=torch.tensor([[0.05, 0.2], [0.95, 1.5]], dtype=torch.float64),
        qvel=torch.tensor([[0.1, -0.3], [0.5, 1.0]], dtype=torch.float64),
        ctrl=torch.tensor([[0.5], [2.5]], dtype=torch.float64))
    t = ilqr.init_solver(env.model, s, env.ilqr).traj
    assert t.qpos.shape[1] == 21 and 21 % 4
    got = linearize_traj(env.model, t, env.cost_fn,
                         with_chunk(env.ilqr.lin, 4))
    jenv = jenvs.pendulum()
    js = JState(**{k: jnp.asarray(v) for k, v in to_numpy(t).items()})
    want = jax.jit(jax.vmap(lambda x: jlinearize_traj(
        jenv.model, x, jenv.cost_fn, JLinCfg(chunk_knots=4))))(js)
    assert got.A.shape == (2, 21, 4, 4) and got.B.shape == (2, 21, 4, 1)
    for name in ("A", "B", "gx", "gu"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-12)


def _distinct_knots(name, T):
    """B=2 instances of ``name``'s qpos0 over T knots, made distinct knot
    by knot (a pad or reshape mix-up cannot cancel out); the hopper's
    root is lowered 15 cm so that its foot is in the ground."""
    env = envs.make(name)
    s = make_state(env.model, 2, device="cpu")
    if name == "hopper":
        qpos = s.qpos.clone()
        qpos[:, 1] -= 0.15          # rootz
        s = s.replace(qpos=qpos)
    traj = s.map(lambda a: a.unsqueeze(1).expand(
        (2, T) + a.shape[1:]).clone())
    k = torch.arange(T, dtype=torch.float64)[None, :, None]
    inst = torch.tensor([0.0, 0.003], dtype=torch.float64)[:, None, None]
    traj = traj.replace(qpos=traj.qpos + 0.01 * k + inst,
                        qvel=traj.qvel + 0.02 * k - inst,
                        ctrl=traj.ctrl + 0.1 * k)
    return env, traj


ENGINE_CASES = {"fd": ("pendulum", 7), "ad": ("hopper", 6),
                "exact": ("tumbler", 5)}


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def unchunked(request):
    engine = request.param
    name, T = ENGINE_CASES[engine]
    env, traj = _distinct_knots(name, T)
    cfg = LinearizeConfig(engine=engine)
    if name == "hopper":
        dist = fwd.pos_stage(env.model, traj.qpos).contacts.dist
        assert bool((dist < 0).any(-1).all()), "a knot out of contact"
    return env, traj, cfg, linearize_traj(env.model, traj, env.cost_fn, cfg)


@pytest.mark.parametrize("c", [3, 2, 7, 10])
def test_chunked_matches_unchunked(unchunked, c):
    env, traj, cfg, full = unchunked
    got = linearize_traj(env.model, traj, env.cost_fn, with_chunk(cfg, c))
    for name in LinOut._fields:
        g, w = getattr(got, name), getattr(full, name)
        assert g.shape == w.shape and g.is_contiguous(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-7,
                                   atol=1e-9,
                                   err_msg=f"chunk_knots={c} field={name}")


def test_graph_cache_static_bytes():
    """The bytes of each held step's static copies of ``c`` and the
    carry (stand-in steps: the cache holds real ones only on a card)."""
    cache = solver._GraphCache(2)
    assert cache.static_bytes() == 0
    f64 = torch.zeros((4, 3), dtype=torch.float64)
    cache.steps["a"] = types.SimpleNamespace(
        c=(f64, f64[:1]), carry=(torch.zeros(5, dtype=torch.bool),))
    cache.steps["b"] = types.SimpleNamespace(
        c=(torch.zeros(2, dtype=torch.float32),), carry=())
    assert cache.static_bytes() == 12 * 8 + 3 * 8 + 5 + 2 * 4


def test_chunk_knots_must_be_positive():
    with pytest.raises(ValueError, match="chunk_knots"):
        LinearizeConfig(chunk_knots=0)


def test_chunked_solve_matches_unchunked():
    """Cart-pole compat+fd at B=2, N=10 (11 knots, so chunks of 8 pad the
    second to 16), 3 iterations."""
    env = envs.pendulum("compat", "fd")
    env = dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, horizon=10, iterations=3))
    gen = torch.Generator().manual_seed(0)
    states, sols = pbatch.init_batched(env, 2, generator=gen, device="cpu")
    sol, trace = ilqr.solve(env.model, env.cost_fn, states, sols, env.ilqr)
    cfg = dataclasses.replace(env.ilqr, lin=with_chunk(env.ilqr.lin, 8))
    sol_c, trace_c = ilqr.solve(env.model, env.cost_fn, states, sols, cfg)
    assert bool(torch.isfinite(trace).all())
    np.testing.assert_allclose(trace_c.numpy(), trace.numpy(), rtol=1e-9)
    for name in ("K", "k"):
        np.testing.assert_allclose(getattr(sol_c, name).numpy(),
                                   getattr(sol, name).numpy(), rtol=1e-3,
                                   atol=1e-6, err_msg=name)


def test_auto_chunk_table():
    for name, b in bench.DEFAULT_BATCH.items():
        assert bench.auto_chunk(name, b) is None, name
    frontier = {"pendulum": 65536, "hopper": 2048, "humanoid": 16,
                "tumbler": 8192}
    assert set(bench.AUTO_CHUNK) == set(frontier)
    for name, b in frontier.items():
        assert bench.auto_chunk(name, b) is None
        assert bench.auto_chunk(name, b + 1) == 8
    assert bench.auto_chunk("pendulum", 131072) == 8
    assert bench.auto_chunk("pendulum", 131073) == 4
    assert bench.auto_chunk("humanoid", 64) == 8
    assert bench.auto_chunk("humanoid", 128) == 4
    assert bench.auto_chunk("hopper", 8192) == 8
    assert bench.auto_chunk("tumbler", 16384) == 8
    assert bench.auto_chunk("cheetah", 4096) is None


def _stub_bench(monkeypatch, fits=lambda batch: True):
    """Replace ``bench.build`` and ``bench.measure``; returns the
    (batch, chunk) of every build."""
    built = []

    def build(env_name, mode, engine, batch, dtype, device, chunk=None):
        built.append((batch, chunk))
        if not fits(batch):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return (None,) * 4
    monkeypatch.setattr(bench, "build", build)
    monkeypatch.setattr(bench, "measure",
                        lambda *a, **k: (5.0, {"trials": 1}))
    monkeypatch.setattr(bench.solver, "clear_graphs", lambda: None)
    return built


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,batch,knob", [
    ("pendulum", 4096, None), ("pendulum", 131072, None),
    ("pendulum", 262144, None), ("hopper", 4096, None),
    ("humanoid", 64, None), ("humanoid", 128, None), ("humanoid", 16, "8"),
    ("tumbler", 1024, "3")])
def test_bench_line_carries_the_chunk(monkeypatch, capsys, name, batch,
                                      knob):
    built = _stub_bench(monkeypatch)
    monkeypatch.setenv("ILQG_BENCH_ENV", name)
    monkeypatch.setenv("ILQG_BENCH_BATCH", str(batch))
    if knob is not None:
        monkeypatch.setenv("ILQG_BENCH_CHUNK", knob)
    assert bench.main(device="cpu") == 0
    line = _line(capsys)
    want = int(knob) if knob else bench.auto_chunk(name, batch)
    assert built == [(batch, want)] and line["chunk_knots"] == want


def test_backoff_picks_the_chunk_again(monkeypatch, capsys):
    built = _stub_bench(monkeypatch, fits=lambda batch: batch <= 16)
    monkeypatch.setenv("ILQG_BENCH_ENV", "humanoid")
    monkeypatch.setenv("ILQG_BENCH_BATCH", "64")
    assert bench.main(device="cpu") == 0
    line = _line(capsys)
    assert built == [(64, 8), (32, 8), (16, None)]
    assert line["batch"] == 16 and line["chunk_knots"] is None
    assert len(line["backoff_from"]) == 2


def test_build_sets_the_chunk():
    env, states, sols, _ = bench.build("pendulum", "compat", "fd", 2,
                                       torch.float64, CPU, 8)
    assert env.ilqr.lin.chunk_knots == 8 and env.ilqr.lin.engine == "fd"
    assert states.qpos.shape[0] == 2
    env, *_ = bench.build("pendulum", "compat", "fd", 2, torch.float64, CPU)
    assert env.ilqr.lin.chunk_knots is None


@pytest.mark.parametrize("cfg,want", [({"batch": 8, "chunk": 8}, "8"),
                                      ({"batch": 8}, None)])
def test_bsweep_row_sets_the_chunk(monkeypatch, cfg, want):
    """The row's process (a stand-in) prints the ILQG_BENCH_CHUNK it got,
    and the bench's graph-cache line; a row without ``chunk`` unsets what
    the sweep's own process had."""
    monkeypatch.setenv("ILQG_BENCH_CHUNK", "4")
    script = ("import json, os, sys; print(json.dumps({'value': 1.0, "
              "'chunk': os.environ.get('ILQG_BENCH_CHUNK')})); "
              "print('bench: CG graph cache 2 shapes held, 1.02 GiB of "
              "static buffers', file=sys.stderr)")
    monkeypatch.setattr(bsweep, "command",
                        lambda device: [sys.executable, "-c", script])
    row = bsweep.run_one("humanoid", dict(cfg, timeout=30), 2, 1, CPU)
    assert "error" not in row and row["chunk"] == want
    assert row["graph_gib"] == 1.02
    assert ("| none |" if want is None else "| 8 |") in bsweep.table(
        [dict(row, chunk_knots=None if want is None else 8)])


def test_bsweep_table_names_a_failed_rows_chunk():
    rows = [{"error": "out of memory", "peak_gib": None, "wall_s": 1.0,
             "config": {"env": "humanoid", "batch": 128}},
            {"error": "out of memory", "peak_gib": None, "wall_s": 1.0,
             "config": {"env": "humanoid", "batch": 128, "chunk": 8}}]
    lines = bsweep.table(rows).splitlines()
    assert "chunk_knots" in lines[0]
    assert "| humanoid | 128 | tassa+ad | 4 | FAILED" in lines[2]
    assert "| humanoid | 128 | tassa+ad | 8 | FAILED" in lines[3]


def test_bsweep_doubles_past_the_unchunked_frontier(monkeypatch, capsys):
    """The default sweep's humanoid row doubles from 16 through the
    chunked batches (each row with the bench's ``auto_chunk``) to its
    first failure."""
    calls = []

    def runner(env_name, cfg, reps, trials, device):
        calls.append(cfg)
        b = cfg["batch"]
        if b > 128:
            return {"error": "out of memory", "peak_gib": None,
                    "config": cfg, "wall_s": 1.0}
        return {"value": 1.0, "batch": b, "peak_gib": None, "config": cfg,
                "wall_s": 1.0, "chunk_knots": bench.auto_chunk("humanoid", b)}
    monkeypatch.setattr(bsweep, "run_one", runner)
    humanoid = next(c for c in bsweep.DEFAULT_SWEEP
                    if c["env"] == "humanoid" and c.get("doubling"))
    assert bsweep.main(["--configs", json.dumps([humanoid])], "cpu") == 0
    assert [c["batch"] for c in calls] == [16, 32, 64, 128, 256]
    assert all("chunk" not in c for c in calls)
    table = capsys.readouterr().out.split("| env |")[1].splitlines()
    assert "| humanoid | 16 | tassa+ad | none |" in table[2]
    assert "| humanoid | 64 | tassa+ad | 8 |" in table[4]
    assert "| humanoid | 256 | tassa+ad | 4 | FAILED" in table[6]


@pytest.mark.parametrize("knob,want", [("8", 8), (None, None)])
def test_roofline_passes_the_chunk(monkeypatch, knob, want):
    got = []

    class Built(Exception):
        pass

    def build(*args):
        got.append(args)
        raise Built
    monkeypatch.setattr(bench, "build", build)
    if knob is not None:
        monkeypatch.setenv("ILQG_BENCH_CHUNK", knob)
    monkeypatch.setenv("ILQG_BENCH_BATCH", "2")
    with pytest.raises(Built):
        roofline.main(device="cpu")
    assert got[0][3] == 2 and got[0][-1] == want
