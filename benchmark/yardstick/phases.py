"""The phase arithmetic of the program's ``tools/perf_breakdown.py``,
copied: a phase fenced on the card by two CUDA events (on the CPU by the
host clock), its milliseconds per call, and a rate from a batch, the
iterations of a solve, the solves and their seconds."""

from __future__ import annotations

import time

import torch


def fenced_s(fn, device) -> float:
    """Seconds of ``fn()``: between two CUDA events on the current stream,
    synchronised on the end event, on the card; the host clock elsewhere."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def ms_per_call(total_s: float, calls: int) -> float:
    return total_s / calls * 1e3


def iters_per_s(batch: int, iterations: int, solves: int,
                seconds: float) -> float:
    """B x iterations x solves over the seconds they took
    (``perf_breakdown``'s ``ilqr_iters_per_s`` for ``solves`` solves)."""
    return batch * iterations * solves / seconds
