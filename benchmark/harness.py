"""One run of one cell: set-up, the measured window, the traced iteration
(with ``--trace 1``), the check against the reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration ``configs/<config>.json`` (with its cost beside it,
``configs/<config>.py``), its traffic mix ``traffic/<traffic>.json`` and
the mix's kind ``kinds/<kind>.py``, its limits ``checks/<cell>.json`` and
each metric's reader ``metrics/<metric>.py``.  A reader's ``read(record)`` returns the metric
from the run's record, or None where the record has nothing for it; the
harness then leaves the metric out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import torch

from . import check, program
from .reference import drive

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ilqg_mujoco_tpu")


@dataclasses.dataclass
class Spec:
    cell: dict
    conf: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: pathlib.Path):
    return json.loads(path.read_text())


def load_spec(workload: str, bench: pathlib.Path = None) -> Spec:
    """The cell ``workload`` of ``BENCHMARK.json`` and all it names."""
    bench = _json(bench or REPO / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = _json(HERE / "configs" / f"{cell['config']}.json")
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = _json(HERE / "checks" / f"{workload}.json")
    here = lambda m: "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in names)]
    return Spec(cell, conf, traffic, limits, e2e, per_layer)


def reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def cache_dirs():
    """Kernel caches inside the checkout, at fixed paths."""
    base = REPO / "build" / "bench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def kind(name: str):
    """The traffic kind ``kinds/<name>.py``."""
    if not name.isidentifier():
        raise KeyError(f"no traffic kind {name!r}")
    return importlib.import_module(f"{__package__}.kinds.{name}")


def reference_rows(spec: Spec, k, loop) -> list:
    """[(program rows, reference rows)] of each compared group, the
    reference in the configuration's own precision on the same draws."""
    dev = spec.traffic["check"]["device"]
    if dev == "cuda" and not torch.cuda.is_available():
        dev = "cpu"
    env = drive.build(spec.conf, device=dev)
    out = []
    with torch.no_grad():
        for prog, draws in loop.compared():
            ref = k.reference(env, draws, prog, spec.traffic)
            out.append((prog, {n: v.cpu() for n, v in ref.items()}))
    return out


def compare(spec: Spec, k, groups: list):
    """(readings, failed answers, answers compared): each answer (a solve's
    instance, or an MPC frame) judged alone on the numbers that the cell's
    limits name, the readings the widest gaps over all of them."""
    readings, failed, n = {}, 0, 0
    for prog, ref in groups:
        for p, r in k.answers(prog, ref):
            every = k.numbers(p, r)
            g = {name: every[name] for name in spec.limits}
            failed += not check.judge(g, spec.limits)[0]
            n += 1
            for name, v in g.items():
                v = math.inf if math.isnan(v) else v
                readings[name] = max(readings.get(name, 0.0), v)
    return readings, failed, n


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device=None, solver=None, tweak=None, out=None, err=None) -> int:
    """One run.  ``device``, ``solver`` and ``tweak`` are for the
    benchmark's own tests and its calibration: a device other than the
    card, a factory ``(conf, traffic, dev)`` of what stands in the
    program's place, and a function that cuts the cell's spec to a test's
    size."""
    out, err = out or sys.stdout, err or sys.stderr
    spec = load_spec(workload)
    if tweak is not None:
        tweak(spec)
    chips = spec.cell["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"this cell needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    cache_dirs()
    k = kind(spec.traffic["kind"])
    if solver is None:
        stand_in = k.Program(program.program_env(spec.conf), spec.traffic,
                             dev)
    else:
        stand_in = solver(spec.conf, spec.traffic, dev)
    loop = k.Loop(spec.conf, spec.traffic, seed, dev, stand_in)
    loop.setup()
    setup_s = time.perf_counter() - t0
    rec = loop.window(seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    rec.update(setup_s=setup_s, peak_bytes=peak, conf=spec.conf,
               traffic=spec.traffic)
    print(k.describe(rec), file=err)
    if trace:
        rec["trace"] = program.traced(loop, dev)
        print(f"traced iteration: phase ms {rec['trace']['phase_ms']}",
              file=err)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=err)
        return 3
    loop.release()
    del stand_in
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, failed, n = compare(spec, k, reference_rows(spec, k, loop))
    correct, _ = check.judge(readings, spec.limits)
    attempted = k.attempted(rec)
    names = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for m in names:
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else dev.type),
                  "count": chips, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": attempted,
            "failed": failed if correct else max(failed, 1),
            "metrics": metrics, "device": device_rec,
            "card": card_line() if dev.type == "cuda" else "cpu",
            "compared": n}
    if trace:
        t = rec["trace"]
        device_rec.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["check"] = {name: {"value": v, "limit": spec.limits[name]["limit"]}
                     for name, v in readings.items()}
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=err)
        return 3
    for s in check.lines(readings, spec.limits):
        print(s, file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0
