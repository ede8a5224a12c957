"""FLOPs and HBM bytes of one batched solve against the card's peaks: the
counterpart of the JAX package's ``tools/roofline.py``.

    python -m ilqg_mujoco_torch.tools.roofline
    ILQG_BENCH_ENV=hopper python -m ilqg_mujoco_torch.tools.roofline

The JAX tool read XLA's cost model of its compiled program.  The port has
no compiled program: it counts its own eager program the same way, op by
op, with a ``TorchDispatchMode`` (:class:`OpCount`) around one solve.  So
the count is an account of *this program*, the operations this port runs
and the bytes they move, as XLA's was of its program; it is not a count of
the algorithm's work whatever implements it (a fused program would move
far fewer bytes for the same arithmetic).

The counting rule (one kernel per op that launches one):

- an op that launches a kernel counts its tensor inputs' bytes once and
  its outputs' bytes once; an input broadcast with stride 0 counts its own
  elements, not the output's;
- views and metadata ops (``alias``, ``view``, ``_unsafe_view``,
  ``expand``, ``transpose``, ``is_same_size``, forward AD's
  ``_has_same_storage_numel`` and zero tangents, the ``empty`` family,
  ``_local_scalar_dense``) count nothing and launch nothing;
- matrix products count ``torch.utils.flop_counter``'s formulas (2mnk),
  a triangular solve n^2 per right-hand side, an elementwise op one FLOP
  per output element, a reduction one per input element, and a copy, a
  concatenation or an index none.

Two kinds of work never reach a dispatch mode, and are counted apart:

- the CG's CUDA-graph replays (``physics/solver``): one
  :func:`solver.step_into` at each captured shape is counted once on
  ``meta`` tensors and multiplied by that shape's replays in the solve
  (``solver._GRAPHS.replays``); the warm-ups and the capture of a graph
  are set-up, and the mode skips them (``_GRAPHS.capturing``);
- the Riccati kernel, which ``ctypes`` calls on raw pointers: each launch
  (``riccati.LAUNCHES``) counts ``riccati.work`` at the solve's shape.

A CG that exits early runs as many iterations as its slowest instance
needs, so the count is of the iterations this run's data needed.

Timing is the JAX tool's chained method: one warm solve (the counted
one), then ``trials`` chains of ``reps`` solves, each consuming the last
one's solver state, timed by ``utils/profiling.Timer``; the best chain's
seconds per solve.
The report has the JAX tool's keys, with ``vs_h100_peak`` in place of
``vs_v5e_peak`` (against the peak of the run's dtype outside the tensor
cores and the HBM rate) and ``ridge_point_flop_per_byte`` for the f32
ridge, plus the least time the card could take (``bound_s``, by
``bound_by``), its share of the measured time (``share_of_bound``), the
count of ops and of kernel launches, the linearizer's ``chunk_knots``,
and ``device`` (the card's name and power limit).  Device rates are null
on the CPU, where only the count means anything.

Env knobs, as the JAX tool's: ILQG_BENCH_ENV (pendulum), ILQG_BENCH_BATCH
(the bench's default batch for the env), ILQG_BENCH_MODE (tassa),
ILQG_BENCH_ENGINE (ad), ILQG_BENCH_REPS (20), ILQG_BENCH_TRIALS (3),
ILQG_BENCH_CHUNK (the linearizer's ``chunk_knots``; unset or empty: every
knot in one pass), and the bench's ILQG_BENCH_DTYPE (float64).  Runs on
the card; only ``main(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import functools
import json
import os
import sys
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import bench
from ..kernels import riccati
from ..physics import solver
from ..physics.model import resolve_device
from ..utils import profiling

aten = torch.ops.aten

# ops that launch no kernel: allocation, metadata (forward AD's storage
# check, its zero tangents), a view that its schema does not declare
# (``_unsafe_view``), the host's read of a scalar (a copy, not a kernel)
NO_KERNEL = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.is_same_size.default,
             aten._has_same_storage_numel.default,
             aten._efficientzerotensor.default, aten._unsafe_view.default,
             aten._local_scalar_dense.default, aten.lift_fresh.default}
# ops tagged pointwise that move data and compute nothing, and an
# elementwise op that is not tagged
NO_FLOPS = {aten.clone.default, aten._to_copy.default}
ELEMENTWISE = {aten.linalg_cross.default}
TRIANGULAR = {aten.linalg_solve_triangular.default,
              aten.triangular_solve.default}


@functools.cache
def _kind(func) -> str:
    """How an op counts: 'none' (no kernel), 'matmul', 'triangular',
    'pointwise', 'reduction' or 'move' (a kernel, no FLOPs)."""
    if func.is_view or func in NO_KERNEL:
        return "none"
    if func.overloadpacket in flop_registry:
        return "matmul"
    if func in TRIANGULAR:
        return "triangular"
    if func in NO_FLOPS:
        return "move"
    if torch.Tag.pointwise in func.tags or func in ELEMENTWISE:
        return "pointwise"
    if torch.Tag.reduction in func.tags:
        return "reduction"
    return "move"


def _own_elements(t: torch.Tensor) -> int:
    """The elements ``t`` holds: its dims of stride 0 count once."""
    if t.is_contiguous() or t.numel() == 0:
        return t.numel()
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (y for y in x if isinstance(y, torch.Tensor))


class OpCount(TorchDispatchMode):
    """FLOPs, bytes and kernel launches of the ops dispatched on
    ``device_type`` while the mode is active (module docstring's rule).
    Only integers from shapes and strides are computed here: the mode runs
    inside CUDA-graph captures too, and must make, copy or sync no
    tensor."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.flops = 0
        self.bytes = 0
        self.launches = 0
        self.ops = 0
        self.by_op: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not solver._GRAPHS.capturing:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        self.ops += 1
        kind = _kind(func)
        if kind == "none":
            return
        ins = {id(t): t
               for t in _tensors(tuple(args) + tuple(kwargs.values()))}
        tensors = list(ins.values()) + list(
            _tensors(out if isinstance(out, (list, tuple)) else (out,)))
        if not any(t.device.type == self.device_type for t in tensors):
            return
        self.launches += 1
        self.by_op[func.__name__] += 1
        self.bytes += sum(_own_elements(t) * t.element_size()
                          for t in tensors)
        if kind == "pointwise":
            self.flops += sum(t.numel() for t in tensors[len(ins):])
        elif kind == "reduction":
            self.flops += next(_tensors(args)).numel()
        elif kind == "matmul":
            self.flops += int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        elif kind == "triangular":
            self.flops += args[1].numel() * args[0].shape[-1]

    def add(self, other: "OpCount", times: int = 1):
        """Add ``times`` runs of ``other``'s count to this one."""
        self.flops += times * other.flops
        self.bytes += times * other.bytes
        self.launches += times * other.launches
        self.ops += times * other.ops
        for name, n in other.by_op.items():
            self.by_op[name] += times * n


def graph_step_count(key) -> OpCount:
    """The count of one replay of the captured CG step ``key``: one
    :func:`solver.step_into` at its shapes, on ``meta`` tensors."""
    c_spec, carry_spec, tolerance, ls_iterations = key
    meta = lambda specs: [torch.empty(shape, dtype=dt, device="meta")
                          for shape, dt, _ in specs]
    c, carry = meta(c_spec), meta(carry_spec)
    with OpCount("meta") as count:
        solver.step_into(c, carry, tolerance, ls_iterations)
    return count


def count_solve(env, solve, states, sols, device) -> dict:
    """One solve under :class:`OpCount`, with the CG's replays and the
    Riccati kernel's launches added; returns the totals."""
    replays0 = Counter(solver._GRAPHS.replays)
    launches0 = riccati.LAUNCHES
    with OpCount(device.type) as count:
        solve(states, sols)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    replays = solver._GRAPHS.replays - replays0
    for key, n in replays.items():
        count.add(graph_step_count(key), n)
    ricc = riccati.LAUNCHES - launches0
    if ricc:
        B, N = states.qpos.shape[0], env.ilqr.horizon
        flops, nbytes = riccati.work(B, N, 2 * env.model.nv,
                                     states.qpos.dtype)
        count.flops += ricc * flops
        count.bytes += ricc * nbytes
        count.launches += ricc
        count.by_op["riccati_compat"] += ricc
    return dict(flops=count.flops, bytes=count.bytes,
                launches=count.launches, ops=count.ops,
                graph_replays=sum(replays.values()), riccati_launches=ricc,
                top_ops=dict(count.by_op.most_common(8)))


def measure(env_name, mode, engine, batch, reps, trials, dtype_name,
            device, chunk=None) -> dict:
    """The JAX tool's report for one configuration (module docstring)."""
    dev = resolve_device(device)
    dtype = bench.DTYPES[dtype_name]
    env, states, sols, solve = bench.build(env_name, mode, engine, batch,
                                           dtype, dev, chunk)
    # the counted solve is the warm one: the kernel's build and the CG's
    # captures, which the count skips
    c = count_solve(env, solve, states, sols, dev)
    timer = profiling.Timer(dev)
    best = None
    for _ in range(trials):
        cur = sols
        with timer.phase("chain") as box:
            for _ in range(reps):
                cur, _ = solve(states, cur)
        t = box["seconds"] / reps
        best = t if best is None else min(best, t)

    on_card = dev.type == "cuda"
    card = lambda x: x if on_card else None
    iters = batch * env.ilqr.iterations
    flops, nbytes = c["flops"], c["bytes"]
    peak = profiling.PEAK_FLOP_S[dtype]
    bound, bound_by = profiling.bound_s(flops, nbytes, dtype)
    return {
        "env": env_name, "batch": batch, "mode": mode, "engine": engine,
        "chunk_knots": chunk,
        "per_solve_call": {
            "flops": flops,
            "hbm_bytes_accessed": nbytes,
            "flops_per_ilqr_iter": flops / iters,
            "bytes_per_ilqr_iter": nbytes / iters,
            "arithmetic_intensity_flop_per_byte": (
                flops / nbytes if nbytes else None),
            "kernel_launches": c["launches"],
            "launches_per_solver_iteration": (
                c["launches"] / env.ilqr.iterations),
            "ops": c["ops"],
            "graph_replays": c["graph_replays"],
            "riccati_launches": c["riccati_launches"],
            "top_ops_by_launches": c["top_ops"],
        },
        "measured": {
            "time_per_call_s": best,
            "ilqr_iters_per_s": iters / best,
            "achieved_flops_per_s": card(flops / best),
            "achieved_hbm_bytes_per_s": card(nbytes / best),
        },
        "vs_h100_peak": {
            "pct_of_flop_peak": card(100.0 * flops / best / peak),
            "pct_of_hbm_bw_peak": card(
                100.0 * nbytes / best / profiling.PEAK_BYTES_S),
            "flop_peak_per_s": peak,
            "flop_peak_of": f"{dtype_name}, outside the tensor cores",
            "hbm_peak_bytes_per_s": profiling.PEAK_BYTES_S,
        },
        "ridge_point_flop_per_byte": peak / profiling.PEAK_BYTES_S,
        "bound_s": bound,
        "bound_by": bound_by,
        "share_of_bound": card(bound / best),
        "solves": 1 + trials * reps,
        "dtype": dtype_name,
        "device": profiling.device_line(dev),
    }


def main(device=None) -> int:
    env_name = os.environ.get("ILQG_BENCH_ENV", "pendulum")
    batch = int(os.environ.get("ILQG_BENCH_BATCH", "0")) or \
        bench.DEFAULT_BATCH.get(env_name, 8192)
    mode = os.environ.get("ILQG_BENCH_MODE", "tassa")
    engine = os.environ.get("ILQG_BENCH_ENGINE", "ad")
    reps = int(os.environ.get("ILQG_BENCH_REPS", "20"))
    trials = int(os.environ.get("ILQG_BENCH_TRIALS", "3"))
    dtype_name = os.environ.get("ILQG_BENCH_DTYPE", "float64")
    chunk = os.environ.get("ILQG_BENCH_CHUNK", "")
    r = measure(env_name, mode, engine, batch, reps, trials, dtype_name,
                resolve_device(device), int(chunk) if chunk else None)
    share = r["share_of_bound"]
    print(f"# {r['device']}: {r['per_solve_call']['flops']:.4g} FLOPs and "
          f"{r['per_solve_call']['hbm_bytes_accessed']:.4g} bytes a solve in "
          f"{r['per_solve_call']['kernel_launches']} launches; the "
          f"{r['bound_by']} bound {r['bound_s']:.4g} s against "
          f"{r['measured']['time_per_call_s']:.4g} s"
          + (f" ({100 * share:.3f}% of the roof)" if share is not None
             else " (a CPU time: no share)"))
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
