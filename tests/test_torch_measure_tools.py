"""The port's measurement tools (``tools/roofline``, ``tools/kernel_bench``,
``tools/bsweep``) on the CPU.

- The roofline's counting mode against FLOPs and bytes computed by hand
  for a matrix product, a broadcast product, a reduction and views, and
  on a dual tensor under forward AD; a
  replay of a captured CG step counted on ``meta`` tensors against the
  same step run eagerly; and a pinned cart-pole compat solve (N=3, one
  iteration, 3 CG iterations) counted at several B: the FLOPs are exactly
  affine in B from B=1, the bytes and launches from B=2 (at B=1 a batched
  ``matmul`` folds its batch of one and skips 108 copies), and two counts
  agree bit for bit.
- ``roofline.main(device="cpu")``'s report has the JAX tool's keys, read
  from ``tools/roofline.py`` with ``ast`` (the JAX tool is not run), with
  ``vs_h100_peak`` for ``vs_v5e_peak``, ``pct_of_flop_peak`` for
  ``pct_of_f32_mxu_peak`` and ``ridge_point_flop_per_byte`` for
  ``ridge_point_flop_per_byte_f32`` (the peak is the run's dtype's).
- ``kernel_bench.main(device="cpu")`` at B=8: on the CPU the kernel's
  route is its plain version, and the plain version and
  ``ilqr.backward_pass_compat`` agree at ``tests/test_torch_riccati.py``'s
  tolerance (rtol 1e-9, atol 1e-11) in float64.
- ``bsweep``'s rows and table with a stubbed row runner (a doubling that
  stops at its first out-of-memory row, a timeout row, every row failed
  exits 1), the row runner's reading of a process that runs out of
  memory, times out or reports its peak, and one real CPU row at B=2
  (the sweep's REPS 2 and TRIALS 1).
"""

import ast
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from ilqg_mujoco_torch import ilqr
from ilqg_mujoco_torch.kernels import riccati
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.parallel import batch as pbatch
from ilqg_mujoco_torch.physics import solver
from ilqg_mujoco_torch.tools import bsweep, kernel_bench, roofline

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The solves here are at B <= 8, too small for torch's intra-op
    threads, which only add CPU time beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def knobs(monkeypatch):
    def set_(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(k, str(v))
    for k in ("ENV", "BATCH", "MODE", "ENGINE", "REPS", "TRIALS", "DTYPE",
              "BACKOFF"):
        monkeypatch.delenv(f"ILQG_BENCH_{k}", raising=False)
    monkeypatch.delenv("REPS", raising=False)
    return set_


def _count(fn, device_type="cpu"):
    with roofline.OpCount(device_type) as c:
        fn()
    return c.flops, c.bytes, c.launches, c.ops


def _f64(*shape):
    return torch.randn(shape, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", ["mm", "broadcast_mul", "sum", "views"])
def test_op_count_by_hand(case):
    """(FLOPs, bytes, launches, ops): 2mnk for a product; a broadcast
    input counts its own elements; a reduction one FLOP per input
    element; views launch nothing."""
    if case == "mm":
        a, b = _f64(3, 4), _f64(4, 5)
        got, want = _count(lambda: a @ b), (2 * 3 * 4 * 5,
                                            8 * (12 + 20 + 15), 1, 1)
    elif case == "broadcast_mul":
        x = torch.ones(3, 1, dtype=torch.float32)
        y = torch.ones(4, dtype=torch.float32).expand(3, 4)  # stride 0
        got, want = _count(lambda: x * y), (12, 4 * (3 + 4 + 12), 1, 1)
    elif case == "sum":
        z = _f64(5, 6)
        got, want = _count(lambda: z.sum(-1)), (30, 8 * (30 + 5), 1, 1)
    else:
        z = _f64(5, 6)
        got = _count(lambda: (z.view(30), z.t(), z.expand(2, 5, 6),
                              z[1:, 2]))
        want = (0, 0, 0, 5)       # view, t, expand, slice, select
    assert got == want


def test_op_count_under_forward_ad():
    """A product of a dual tensor counts its primal and its tangent
    products; forward AD's zero tangents and storage checks launch
    nothing."""
    x = torch.ones(5, dtype=torch.float64)
    with fwAD.dual_level():
        d = fwAD.make_dual(x, torch.ones_like(x))
        with roofline.OpCount("cpu") as c:
            d * 3.0
    assert c.by_op["mul.Tensor"] == 2 and c.flops == 2 * 5
    assert not {"_has_same_storage_numel.default",
                "_efficientzerotensor.default"} & set(c.by_op)


def test_riccati_work_counts_each_element_once():
    """684 elements an instance at N=20, n=4 (A, B, gx, gu, gaps in; K, k
    out), and the bound of the main path's launch in float64 is the bytes'."""
    ops, nbytes = riccati.work(4096, 20, 4, torch.float64)
    assert nbytes == 4096 * 684 * 8
    assert ops == 4096 * 20 * (4 * 64 + 15 * 16 + 14 * 4 + 10)
    args = [torch.empty(s, dtype=torch.float64, device="meta") for s in (
        (4096, 20, 4, 4), (4096, 20, 4, 1), (4096, 21, 4), (4096, 20, 1),
        (4096, 20, 4))]
    ms, by = riccati.bound_ms(args, torch.float64)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / 3.35e12)


def _pinned_cartpole():
    env = envs.pendulum("compat", "fd")
    opt = dataclasses.replace(env.model.opt, tolerance=0.0, iterations=3)
    return dataclasses.replace(
        env, model=dataclasses.replace(env.model, opt=opt),
        ilqr=dataclasses.replace(env.ilqr, horizon=3, iterations=1))


def test_graph_step_count_equals_eager_step(monkeypatch):
    """One CG step counted as a replay is (``meta`` tensors at the cache's
    key) equals the same step counted eagerly on the CPU tensors."""
    env = _pinned_cartpole()
    seen = []
    step = solver._cg_step

    def record(c, carry, tolerance, ls_iterations):
        if not seen:
            seen.append(([t.clone() for t in c], [t.clone() for t in carry],
                         tolerance, ls_iterations))
        return step(c, carry, tolerance, ls_iterations)
    monkeypatch.setattr(solver, "_cg_step", record)
    states, sols = pbatch.init_batched(env, 2, device="cpu")
    c, carry, tol, ls = seen[0]
    meta = roofline.graph_step_count(solver.graph_key(c, carry, tol, ls))
    eager = _count(lambda: solver.step_into(c, carry, tol, ls))
    assert (meta.flops, meta.bytes, meta.launches, meta.ops) == eager
    assert meta.launches > 50


def test_counted_solve_affine_in_batch():
    env = _pinned_cartpole()
    solve = pbatch.make_batched_solve(env)
    counts = {}
    for B in (1, 2, 3, 4):
        states, sols = pbatch.init_batched(
            env, B, generator=torch.Generator().manual_seed(0), device="cpu")
        counts[B] = roofline.count_solve(env, solve, states, sols, CPU)
    again = roofline.count_solve(env, solve, states, sols, CPU)
    assert again == counts[4]
    f = [counts[B]["flops"] for B in (1, 2, 3, 4)]
    assert f[1] - f[0] == f[2] - f[1] == f[3] - f[2] > 0
    for key in ("bytes", "launches", "ops"):
        v = [counts[B][key] for B in (2, 3, 4)]
        assert v[1] - v[0] == v[2] - v[1], key
    assert counts[2]["launches"] == counts[4]["launches"]
    assert counts[1]["launches"] < counts[2]["launches"]
    # on the CPU the CG runs eagerly and the kernel's plain version runs
    assert counts[4]["graph_replays"] == 0
    assert counts[4]["riccati_launches"] == 0


def _jax_report_keys():
    """The JAX tool's report: {key: nested keys or None}."""
    tree = ast.parse((ROOT / "tools" / "roofline.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "report"):
            return {k.value: ([kk.value for kk in v.keys]
                              if isinstance(v, ast.Dict) else None)
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no report dict in tools/roofline.py")


def test_roofline_report_has_the_jax_keys(knobs, capsys, monkeypatch):
    """The cart-pole compat+fd at B=2, its solver cut to N=4 and 2
    iterations."""
    knobs(ILQG_BENCH_ENV="pendulum", ILQG_BENCH_MODE="compat",
          ILQG_BENCH_ENGINE="fd", ILQG_BENCH_BATCH=2, ILQG_BENCH_REPS=1,
          ILQG_BENCH_TRIALS=1)
    make = envs.make

    def cut(*a, **kw):
        env = make(*a, **kw)
        return dataclasses.replace(env, ilqr=dataclasses.replace(
            env.ilqr, horizon=4, iterations=2))
    monkeypatch.setattr(envs, "make", cut)
    assert roofline.main(device="cpu") == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rename = {"vs_v5e_peak": "vs_h100_peak",
              "pct_of_f32_mxu_peak": "pct_of_flop_peak",
              "ridge_point_flop_per_byte_f32": "ridge_point_flop_per_byte"}
    for key, nested in _jax_report_keys().items():
        key = rename.get(key, key)
        assert key in r, key
        for k in nested or ():
            assert rename.get(k, k) in r[key], (key, k)
    per = r["per_solve_call"]
    assert (r["env"], r["batch"], r["mode"], r["engine"]) == (
        "pendulum", 2, "compat", "fd")
    assert per["flops"] > 0 and per["hbm_bytes_accessed"] > 0
    assert per["flops_per_ilqr_iter"] == per["flops"] / 4
    assert per["kernel_launches"] > 0 and r["solves"] == 2
    assert r["bound_by"] in ("bytes", "operations") and r["bound_s"] > 0
    assert r["measured"]["time_per_call_s"] > 0
    # no device rate from a CPU run
    assert r["device"] == "cpu" and r["share_of_bound"] is None
    assert r["measured"]["achieved_hbm_bytes_per_s"] is None
    assert r["vs_h100_peak"]["pct_of_flop_peak"] is None


def test_kernel_bench_general_recursion_agrees(knobs, capsys):
    knobs(ILQG_BENCH_BATCH=8, REPS=1)
    assert kernel_bench.main(device="cpu") == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [(ln["batch"], ln["dtype"]) for ln in lines] == [
        (8, "float32"), (kernel_bench.MAIN_BATCH, "float64")]
    for ln in lines:
        assert all(ln["agreement"]["within_tolerance"].values())
        assert ln["launches"] == 0 and ln["kernel_ms_graph"] is None
        assert ln["device"] == "cpu" and ln["bound_by"] == "bytes"
        for k in ("kernel_ms", "general_recursion_ms", "plain_ms"):
            assert ln[k] > 0
    env, traj, lin, args = kernel_bench.inputs(8, torch.float64, CPU)
    N = env.ilqr.horizon
    K, k = ilqr.backward_pass_compat(env.model, traj, lin, env.ilqr)
    Kp, kp = riccati.backward_compat_batched_ref(*args, env.ilqr.mu)
    np.testing.assert_allclose(K[:, :N].numpy(), Kp.numpy(), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(k[:, :N].numpy(), kp.numpy(), rtol=1e-9,
                               atol=1e-11)
    # every lane carries its own noise
    assert not torch.equal(args[0][0], args[0][1])


def _stub(fail_above=None, timeout_at=None):
    calls = []

    def runner(env_name, cfg, reps, trials, device):
        calls.append(dict(cfg, reps=cfg.get("reps", reps)))
        b = cfg["batch"]
        if timeout_at is not None and b == timeout_at:
            return {"error": "timeout", "peak_gib": None, "config": cfg,
                    "wall_s": 1.0}
        if fail_above is not None and b > fail_above:
            return {"error": "out of memory", "peak_gib": None,
                    "config": cfg, "wall_s": 2.0}
        return {"value": 10.0 * b, "spread": {"min": 1, "median": 2,
                                              "max": 3},
                "batch": b, "peak_gib": b / 1024, "config": cfg,
                "wall_s": 3.0, "vs_baseline": None}
    return runner, calls


def test_bsweep_doubles_to_the_first_failure(capsys, monkeypatch):
    runner, calls = _stub(fail_above=8192, timeout_at=24)
    monkeypatch.setattr(bsweep, "run_one", runner)
    configs = [{"env": "pendulum", "mode": "compat", "engine": "fd",
                "batch": 2048, "doubling": True},
               {"env": "humanoid", "batch": 24}]
    rc = bsweep.main(["--configs", json.dumps(configs)], "cpu")
    assert rc == 0
    assert [c["batch"] for c in calls] == [2048, 4096, 8192, 16384, 24]
    assert all(c["reps"] == 2 and "doubling" not in c for c in calls)
    out = capsys.readouterr().out
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(rows) == 5 and rows[3]["error"] == "out of memory"
    table = out[out.index("| env |"):].splitlines()
    assert "peak GiB" in table[0] and "GiB per instance" in table[0]
    assert len(table) == 2 + 5
    assert "| 4096 |" in table[3] and "| 4.0 | 0.0009766 |" in table[3]
    assert "FAILED" in table[5] and "out of memory" in table[5]
    assert "FAILED" in table[6] and "timeout" in table[6]


def test_bsweep_every_row_failed_exits_1(capsys, monkeypatch):
    runner, calls = _stub(fail_above=0)
    monkeypatch.setattr(bsweep, "run_one", runner)
    assert bsweep.main(["--configs", json.dumps(
        [{"batch": 8, "doubling": True}, {"batch": 4}])], "cpu") == 1
    assert [c["batch"] for c in calls] == [8, 4]


def test_bsweep_default_sweep_covers_six_paths():
    rows = [c for c in bsweep.DEFAULT_SWEEP if c.get("doubling")]
    assert [(c["env"], c["mode"], c["engine"]) for c in rows] == list(
        bsweep.PATHS)
    assert [c["batch"] for c in rows] == [4096, 4096, 1024, 1024, 1024, 16]
    assert {"env": "humanoid", "batch": 24} in bsweep.DEFAULT_SWEEP


@pytest.mark.parametrize("case", ["oom", "timeout", "peak"])
def test_bsweep_row_reads_its_process(case, monkeypatch):
    """A stand-in for the bench's process: one that prints the bench's
    out-of-memory line and exits 1, one that outlives its timeout, and one
    that prints a line and its peak memory to stderr."""
    script = {
        "oom": "import json, sys; print(json.dumps({'value': 0, 'errors': "
               "['B=8: OutOfMemoryError: CUDA out of memory.']})); "
               "sys.exit(1)",
        "timeout": "import time; time.sleep(30)",
        "peak": "import json, sys; print(json.dumps({'value': 5.0})); "
                "print('bench: peak device memory 3.52 GiB at B=8', "
                "file=sys.stderr)"}[case]
    monkeypatch.setattr(bsweep, "command",
                        lambda device: [sys.executable, "-c", script])
    row = bsweep.run_one("pendulum", {"batch": 8, "timeout": 2}, 2, 1, CPU)
    assert row["config"] == {"batch": 8, "timeout": 2}
    if case == "peak":
        assert row["value"] == 5.0 and row["peak_gib"] == 3.52
        assert "error" not in row
    else:
        assert row["error"] == {"oom": "out of memory",
                                "timeout": "timeout"}[case]


def test_bsweep_real_cpu_row(capsys, monkeypatch):
    """One row of the bench in a fresh CPU process: cart-pole compat+fd,
    B=2, REPS 2, TRIALS 1 (a warm solve and chains of one and two).  The
    row's own command runs, after a line that cuts the env's solver to N=6
    and 3 iterations."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cmd = bsweep.command(CPU)
    assert cmd[1] == "-c"
    cut = ("import dataclasses\n"
           "from ilqg_mujoco_torch.models import envs\n"
           "make = envs.make\n"
           "envs.make = lambda *a, **k: (lambda e: dataclasses.replace(\n"
           "    e, ilqr=dataclasses.replace(e.ilqr, horizon=6,\n"
           "                                iterations=3)))(make(*a, **k))\n")
    monkeypatch.setattr(bsweep, "command",
                        lambda device: cmd[:2] + [cut + cmd[2]])
    configs = [{"env": "pendulum", "mode": "compat", "engine": "fd",
                "batch": 2, "timeout": 300}]
    assert bsweep.main(["--configs", json.dumps(configs)], "cpu") == 0
    out = capsys.readouterr().out
    row = json.loads(next(ln for ln in out.splitlines()
                          if ln.startswith("{")))
    assert row["metric"] == "ilqr_iters_per_s_pendulum_batch2_compat_fd"
    assert row["batch"] == 2 and row["value"] > 0 and row["device"] == "cpu"
    assert row["peak_gib"] is None and row["wall_s"] > 0
    assert "| pendulum | 2 | compat+fd |" in out
