"""Phase timers, spans and counters, a device trace and throughput: the
port of ``ilqg_mujoco_tpu/utils/profiling.py``, with the spans added.

Spans and counters mark the program's own layers from inside:
:func:`span` around a phase of the solve, :func:`count` where a loop
repeats, both recorded only inside :func:`tracing`.  With tracing off a
span is one shared object that does nothing, and a count returns at once.

On the card a :class:`Timer` phase is timed by two CUDA events on the
current stream, and the phase synchronizes on its end event when it exits,
so the time covers all the work the phase enqueued.  On the CPU it is
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


class _Off:
    """The span of tracing off, one object for every call: it allocates,
    records and times nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_STORE = None       # the SpanStore that records, while tracing() is on


class Span:
    """One span: its name, its path of names from its root (``a/b/c``), its
    id and its parent's (None at the root), the request it serves (None
    outside a solve), its host start and end in ``time.perf_counter_ns``,
    the counters added while it was the innermost open span, and with
    ``device=True`` a pair of CUDA events recorded on the current stream at
    entry and exit, resolved into ``device_ms`` by
    :meth:`SpanStore.resolve`."""
    __slots__ = ("store", "name", "path", "id", "parent", "request",
                 "start_ns", "end_ns", "counts", "events", "device_ms",
                 "_rf")

    def __init__(self, store, name, parent, request):
        self.store, self.name, self.request = store, name, request
        self.path = name if parent is None else parent.path + "/" + name
        self.parent = None if parent is None else parent.id
        store.opened += 1
        self.id = store.opened
        self.start_ns = self.end_ns = 0
        self.counts, self.events, self.device_ms = {}, None, None

    def __enter__(self):
        # the profiler's event encloses the span's own stamps
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[0].record(self.store.stream())
        self.store.spans.append(self)
        self.store.stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.store.stream())
        self.end_ns = time.perf_counter_ns()
        self.store.stack.pop()
        self._rf.__exit__(*exc)
        return False


class SpanStore:
    """The spans and counters recorded since :meth:`clear`, in memory
    until the caller reads them.  ``anchor`` is one (``time.time_ns``,
    ``time.perf_counter_ns``) pair taken when tracing started: the spans
    are stamped with ``perf_counter_ns`` and exported on the Unix-epoch ns
    clock of ``torch.profiler``'s events (:meth:`unix_ns`)."""

    def __init__(self, device=None):
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = (torch.device(device) if device is not None
                       and torch.device(device).type == "cuda" else None)
        self.anchor = (time.time_ns(), time.perf_counter_ns())
        self.requests = self.opened = 0
        self.spans, self.stack, self.loose = [], [], {}

    def stream(self):
        return torch.cuda.current_stream(self.device)

    def open(self, name, device, request):
        parent = self.stack[-1] if self.stack else None
        if request:
            self.requests += 1
            req = self.requests
        else:
            req = parent.request if parent is not None else None
        s = Span(self, name, parent, req)
        if device and self.device is not None:
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        return s

    def add(self, name, n):
        counts = self.stack[-1].counts if self.stack else self.loose
        counts[name] = counts.get(name, 0) + n

    def unix_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` stamp on the profiler's clock."""
        return perf_ns + self.anchor[0] - self.anchor[1]

    def resolve(self):
        """Each closed device span's ``device_ms``, from its events: one
        synchronisation of the card, made after the traced work."""
        todo = [s for s in self.spans if s.events is not None and s.end_ns]
        if todo:
            torch.cuda.synchronize(self.device)
        for s in todo:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None

    def counters(self) -> dict:
        """Each counter's total over every span and outside them."""
        total = dict(self.loose)
        for s in self.spans:
            for k, v in s.counts.items():
                total[k] = total.get(k, 0) + v
        return total

    def export(self) -> list:
        """Every closed span as a dict, stamped on the profiler's clock."""
        self.resolve()
        return [{"name": s.name, "path": s.path, "id": s.id,
                 "parent": s.parent, "request": s.request,
                 "start_ns": self.unix_ns(s.start_ns),
                 "end_ns": self.unix_ns(s.end_ns), "device_ms": s.device_ms,
                 "counts": dict(s.counts)}
                for s in self.spans if s.end_ns]

    def summary(self) -> dict:
        """``{"spans": {path: {"n", "host_ms", "device_ms"}}, "counters":
        {name: total}}`` over the closed spans; ``device_ms`` sums the
        spans timed on the card and is None where none was."""
        by = {}
        for s in self.export():
            row = by.setdefault(s["path"], {"n": 0, "host_ms": 0.0,
                                            "device_ms": None})
            row["n"] += 1
            row["host_ms"] += (s["end_ns"] - s["start_ns"]) / 1e6
            if s["device_ms"] is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) + s["device_ms"]
        return {"spans": by, "counters": self.counters()}

    def clear(self):
        """Forget every span and counter (a span still open goes on, and
        what opens inside it still names it in its path)."""
        self.spans, self.loose = [], {}
        for s in self.stack:
            s.counts = {}


def span(name: str, device: bool = False, request: bool = False):
    """A context manager around one span of the program: recorded while
    :func:`tracing` is on, under the innermost open span, and seen by
    ``torch.profiler`` as ``record_function(name)``.  ``device=True`` times
    it on the card as well; ``request=True`` opens a new request id, which
    every span inside it shares.  With tracing off it returns one shared
    object that does nothing."""
    if _STORE is None:
        return _OFF
    return _STORE.open(name, device, request)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` of the innermost open span (nothing
    with tracing off)."""
    if _STORE is None:
        return
    _STORE.add(name, n)


@contextlib.contextmanager
def tracing(device=None):
    """Record spans and counters over the body; yields the
    :class:`SpanStore`.  Device spans are timed on ``device`` where it is a
    card (by default the current card where there is one).  Inside another
    ``tracing`` it yields the store already recording."""
    global _STORE
    if _STORE is not None:
        yield _STORE
        return
    _STORE = SpanStore(device)
    try:
        yield _STORE
    finally:
        _STORE = None


def device_ops(prof, skip=()) -> list:
    """(name, start_ns, end_ns) of each operation on the card (kernels,
    copies, fills) in a finished ``torch.profiler`` session, on the
    profiler's clock, sorted by start, but for events named in ``skip``.
    Give it the spans' names: the card's timeline carries a copy of each
    span's ``record_function`` range (a user annotation), which covers
    the span's kernels and the gaps between them and is no operation."""
    cuda = torch.autograd.DeviceType.CUDA
    skip = set(skip)
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and e.name() not in skip),
                  key=lambda op: op[1])


def innermost(spans) -> list:
    """The host's timeline cut where its innermost open span changes:
    [(start_ns, end_ns, path)], sorted and disjoint, from closed spans as
    :meth:`SpanStore.export` gives them (properly nested, as spans on one
    thread are)."""
    out, stack, at = [], [], None
    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        while stack and stack[-1][0] <= s["start_ns"]:
            end, path = stack.pop()
            out.append((at, end, path))
            at = end
        if stack:
            out.append((at, s["start_ns"], stack[-1][1]))
        at = s["start_ns"]
        stack.append((s["end_ns"], s["path"]))
    while stack:
        end, path = stack.pop()
        out.append((at, end, path))
        at = end
    return [seg for seg in out if seg[1] > seg[0]]


def idle_by_span(ops, spans, start_ns, end_ns, top=10) -> tuple:
    """The card's idle time in [start_ns, end_ns] (no operation of ``ops``,
    :func:`device_ops`, running) charged to the innermost span the host was
    in (:func:`innermost`; None where it was in no span).  Returns ({path:
    idle ns}, the ``top`` longest gaps between two operations as [(ns,
    path, the operation before the gap)], each named by the span that
    covers most of it)."""
    idle, gaps, at, prev = [], [], start_ns, None
    for name, a, b in ops:
        if a > at:
            idle.append((at, min(a, end_ns)))
            if prev is not None:
                gaps.append((a - at, len(idle) - 1, prev))
        if b > at:
            at, prev = b, name
    if end_ns > at:
        idle.append((at, end_ns))
    segs = innermost(spans)
    share = [dict() for _ in idle]
    j = 0
    for i, (a, b) in enumerate(idle):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(segs) and segs[k][0] < b:
            ns = min(b, segs[k][1]) - max(a, segs[k][0])
            share[i][segs[k][2]] = share[i].get(segs[k][2], 0) + ns
            covered += ns
            k += 1
        if b - a > covered:
            share[i][None] = share[i].get(None, 0) + b - a - covered
    total = {}
    for sh in share:
        for path, ns in sh.items():
            total[path] = total.get(path, 0) + ns
    gaps = sorted(gaps, reverse=True)[:top]
    return total, [(ns, max(share[i], key=share[i].get), op)
                   for ns, i, op in gaps]


@contextlib.contextmanager
def trace(logdir):
    """``torch.profiler`` over the body (the card's kernels too where there
    is a card), with the program's spans recorded (:func:`tracing`), so
    their names lie over the operations.  Writes ``logdir/trace.json``, a
    Chrome trace, and ``logdir/spans.json``: the spans and counters
    (:meth:`SpanStore.summary`) and, where the card was traced, its idle
    time charged to spans and its longest gaps (:func:`idle_by_span`)."""
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof, tracing() as store:
        t0 = time.perf_counter_ns()
        yield prof
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    prof.export_chrome_trace(str(out / "trace.json"))
    rec = store.summary()
    if on_card:
        spans = store.export()
        ops = device_ops(prof, {s["name"] for s in spans})
        idle, gaps = idle_by_span(ops, spans, store.unix_ns(t0),
                                  store.unix_ns(t1))
        rec["idle_ms"] = {str(p): ns / 1e6 for p, ns in idle.items()}
        rec["gaps"] = [[str(p), ns / 1e6, op] for ns, p, op in gaps]
    (out / "spans.json").write_text(json.dumps(rec, indent=1))


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
