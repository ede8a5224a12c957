"""The traced part of a ``--trace 1`` run, after the window: one iteration
of the cell's own solve, phase by phase.

First each phase is timed alone, fenced by CUDA events
(``yardstick.phases.fenced_s``).  Then each phase runs once more under its
own ``torch.profiler`` session that records the card's activity only, and
the device events of that session are reduced here: their count (kernel
launches; copies and fills are device operations but not launches), the
union of their intervals (the seconds in which an operation ran on the
device), the gaps between them, named by the phase the host was in and the
operation before the gap, the time of each operation by name, and the
Riccati kernel's own time.  The traced window is the sum of the phases'
host seconds, each phase between two synchronisations.
"""

from __future__ import annotations

import heapq
import time
import warnings
from collections import Counter

import torch

from .yardstick import phases as ph

RICCATI = "riccati_compat_kernel"
TOP = 10


def _device_events(prof, device_type):
    """(name, start_ns, duration_ns) of every event of ``device_type`` in a
    finished profiler session, read from its raw results."""
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is not None:
        for e in raw.events():
            if e.device_type() == device_type:
                try:
                    yield e.name(), e.start_ns(), e.duration_ns()
                except AttributeError:
                    yield (e.name(), e.start_us() * 1000,
                           e.duration_us() * 1000)
        return
    for e in prof.events():
        if e.device_type == device_type:
            yield (e.name, int(e.time_range.start * 1e3),
                   int(e.time_range.elapsed_us() * 1e3))


def profile_phases(named, device) -> dict:
    """Profile ``named`` [(phase, fn)], one session each."""
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    act = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    dtype = (torch.autograd.DeviceType.CUDA if on_card
             else torch.autograd.DeviceType.CPU)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {"launches": 0, "ops": 0, "busy_s": 0.0, "window_s": 0.0,
           "riccati_s": 0.0, "riccati_launches": 0}
    by_name, gaps = Counter(), []
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    for phase, fn in named:
        sync()
        with profile(activities=[act]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            out["window_s"] += time.perf_counter() - t0
        evs = sorted(_device_events(prof, dtype), key=lambda e: e[1])
        end, prev = None, None
        for name, start, dur in evs:
            out["ops"] += 1
            if not name.startswith(("Memcpy", "Memset")):
                out["launches"] += 1
            by_name[name] += dur
            if RICCATI in name:
                out["riccati_s"] += dur / 1e9
                out["riccati_launches"] += 1
            stop = start + dur
            if end is None:
                busy_from = start
            elif start > end:
                out["busy_s"] += (end - busy_from) / 1e9
                gap = (start - end) / 1e9
                item = (gap, f"{phase} after {prev[:80]}")
                if len(gaps) < TOP:
                    heapq.heappush(gaps, item)
                else:
                    heapq.heappushpop(gaps, item)
                busy_from = start
            if end is None or stop > end:
                end, prev = stop, name
        if end is not None:
            out["busy_s"] += (end - busy_from) / 1e9
    out["device_ops"] = [[n[:120], s / 1e9]
                         for n, s in by_name.most_common(TOP)]
    out["idle_gaps"] = [[n, g] for g, n in sorted(gaps, reverse=True)]
    return out


def time_phases(named, device) -> dict:
    """Milliseconds of each phase of ``named``, each fenced alone."""
    return {phase: ph.ms_per_call(ph.fenced_s(fn, device), 1)
            for phase, fn in named}
