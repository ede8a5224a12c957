"""Phase timers, a device trace and throughput: the port of
``ilqg_mujoco_tpu/utils/profiling.py``.

On the card a phase is timed by two CUDA events on the current stream,
and the phase synchronizes on its end event when it exits, so the time
covers all the work the phase enqueued.  On the CPU it is
``time.perf_counter``.  :func:`device_line` names the device a number was
measured on.

Also the card's timers of a single function (:func:`time_cuda`,
:func:`time_warm`, :func:`time_cold`) and the H100's data-sheet peaks that
a bound (:func:`bound_s`) divides the work by.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import statistics
import subprocess
import time
from typing import Dict

import torch

from ..physics.model import resolve_device

# H100 SXM data-sheet peaks at 700 W: HBM bandwidth, float64 and float32
# rates outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float64: 34e12, torch.float32: 67e12}
L2_FLUSH_BYTES = 128 * 2 ** 20      # over twice the H100's 50 MB L2


class Timer:
    """Named phase timers on one device (the card unless the CPU is asked
    for).

    >>> t = Timer()
    >>> with t.phase("solve") as box:
    ...     out = solve(...)          # fenced on exit
    >>> box["seconds"], t.report()
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the body; its seconds land in the yielded dict under
        ``"seconds"`` when the phase exits."""
        box = {}
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        else:
            t0 = time.perf_counter()
        try:
            yield box
        finally:
            if self.device.type == "cuda":
                end.record(stream)
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                dt = time.perf_counter() - t0
            box["seconds"] = dt
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.times.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:8.3f}s  x{n}  "
                         f"{total / n * 1e3:8.2f} ms/call")
        out = "\n".join(lines)
        print(out)
        return out

    def as_json(self) -> str:
        return json.dumps({
            k: {"total_s": v, "count": self.counts[k]}
            for k, v in self.times.items()})


@contextlib.contextmanager
def trace(logdir):
    """``torch.profiler`` over the body (the card's kernels too where there
    is a card); writes ``logdir/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def device_line(device=None) -> str:
    """The device a measurement runs on, as it is written beside the
    number: the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for
    the first card (a card may be set below its maximum power and then runs
    slower), or ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def throughput(n_items: int, seconds: float, unit: str = "items") -> str:
    return f"{n_items / seconds:,.0f} {unit}/s"


def bound_s(flops: float, nbytes: float, dtype) -> tuple:
    """Least seconds the work could take on an H100 SXM: the larger of the
    bytes over the HBM rate and the operations over the dtype's peak.
    Returns (seconds, 'bytes' | 'operations')."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOP_S[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_cuda(fn, reps, warmup):
    """Device ms per call of ``fn``: ``warmup`` calls, then ``reps`` calls
    between two CUDA events (the host's launch cost included where it
    exceeds the device's time)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture(fn, calls):
    """A CUDA graph of ``calls`` calls of ``fn`` (warmed on a side stream
    first, as torch.cuda.graphs asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def time_warm(fn, calls=50, replays=10):
    """Device ms per call of ``fn``, its inputs warm in L2: ``calls`` calls
    captured in one CUDA graph, replayed ``replays`` times between two
    events, so the host's launch cost is not timed."""
    graph = capture(fn, calls)
    graph.replay()
    return time_cuda(graph.replay, replays, 1) / calls


def time_cold(fn, reps=30):
    """Median device ms of one call of ``fn`` with L2 cold: before each call
    a 128 MB buffer (over twice the 50 MB L2) is written, and each call,
    replayed from a one-call CUDA graph, lies between its own events.  The
    write keeps the card busy while the host enqueues the call."""
    graph = capture(fn, 1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    events = []
    for _ in range(reps):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)
