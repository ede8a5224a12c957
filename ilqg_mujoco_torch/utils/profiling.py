"""Phase timers, a device trace and throughput: the port of
``ilqg_mujoco_tpu/utils/profiling.py``.

On the card a phase is timed by two CUDA events on the current stream,
and the phase synchronizes on its end event when it exits, so the time
covers all the work the phase enqueued.  On the CPU it is
``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time
from typing import Dict

import torch

from ..physics.model import resolve_device


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


def throughput(n_items: int, seconds: float, unit: str = "items") -> str:
    return f"{n_items / seconds:,.0f} {unit}/s"
