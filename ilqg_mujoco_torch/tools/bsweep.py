"""Batch sweep: the port's bench in a fresh process per configuration, the
counterpart of the JAX package's ``tools/bsweep.py``.

    python -m ilqg_mujoco_torch.tools.bsweep --out sweep.jsonl
    python -m ilqg_mujoco_torch.tools.bsweep --configs \\
        '[{"env": "hopper", "batch": 2048, "reps": 2, "trials": 1}]'

Each row runs ``python -m ilqg_mujoco_torch.bench`` in its own process
with ``ILQG_BENCH_BACKOFF=0``, so that a row reports its own batch and a
row that does not fit takes its allocator and captured graphs with it.  A
row records the bench line, the peak device memory and the static bytes
of the CG graphs held at the end (the bench's stderr lines: ``peak_gib``,
``graph_gib``) and ``wall_s``; a row that fails is a row too, with its
batch and ``error`` (``out of memory``, ``timeout`` after the row's
``timeout`` seconds, or the end of the process's output).  The process
exits 1 only when every row failed.

A config is a dict: ``env`` (``--env`` where absent), ``batch``, ``mode``
(tassa), ``engine`` (ad), ``reps`` and ``trials`` (``--reps``, 2, and
``--trials``, 1: the JAX tool's 20 and 5 timed TPU solves of
milliseconds, a card's solve takes seconds to a minute), ``dtype``
(float64), ``chunk`` (the linearizer's ``chunk_knots``, as
``ILQG_BENCH_CHUNK``; without it the variable is unset and the bench picks
``bench.auto_chunk``'s), ``timeout`` (1500 s), ``backoff`` ("0"); with
``"doubling": true`` it stands for rows at batch, 2 batch, 4 batch ... up
to the first row that fails.  The default sweep doubles each of the six
paths of the port's bench from its default batch (the cart-pole compat+fd
and tassa+ad, the hopper tassa+ad and compat+fd, the tumbler, the
humanoid), past each one's unchunked frontier through ``auto_chunk``, and
adds the humanoid at B=24 (chunked by ``auto_chunk``).

Prints each row as a JSON line as it ends, then a markdown table with
each row's ``chunk_knots``, the peak GiB and the GiB per instance.  Runs
on the card; ``main(device="cpu")`` runs its rows on the CPU (the bench's
``main("cpu")`` in a fresh process).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time

from ..bench import DEFAULT_BATCH, auto_chunk
from ..physics.model import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
PATHS = (("pendulum", "compat", "fd"), ("pendulum", "tassa", "ad"),
         ("hopper", "tassa", "ad"), ("hopper", "compat", "fd"),
         ("tumbler", "tassa", "ad"), ("humanoid", "tassa", "ad"))
DEFAULT_SWEEP = [
    {"env": env, "mode": mode, "engine": engine,
     "batch": DEFAULT_BATCH[env], "doubling": True}
    for env, mode, engine in PATHS] + [{"env": "humanoid", "batch": 24}]
PEAK = re.compile(r"bench: peak device memory ([0-9.]+) GiB")
GRAPHS = re.compile(r"bench: CG graph cache \d+ shapes held, ([0-9.]+) GiB")


def command(device):
    """The row's process: the bench's ``python -m`` entry on the card, its
    ``main("cpu")`` on the CPU."""
    if device.type == "cuda":
        return [sys.executable, "-m", "ilqg_mujoco_torch.bench"]
    return [sys.executable, "-c", "import sys; from ilqg_mujoco_torch "
            "import bench; sys.exit(bench.main('cpu'))"]


def run_one(env_name, cfg, reps, trials, device):
    """One row: the bench at ``cfg`` in a fresh process."""
    env = dict(os.environ)
    env["ILQG_BENCH_ENV"] = cfg.get("env", env_name)
    env["ILQG_BENCH_BATCH"] = str(cfg.get("batch", 0))
    env["ILQG_BENCH_REPS"] = str(cfg.get("reps", reps))
    env["ILQG_BENCH_TRIALS"] = str(cfg.get("trials", trials))
    env["ILQG_BENCH_MODE"] = cfg.get("mode", "tassa")
    env["ILQG_BENCH_ENGINE"] = cfg.get("engine", "ad")
    env["ILQG_BENCH_DTYPE"] = cfg.get("dtype", "float64")
    if "chunk" in cfg:
        env["ILQG_BENCH_CHUNK"] = str(cfg["chunk"])
    else:
        env.pop("ILQG_BENCH_CHUNK", None)
    # a sweep row reports ITS batch: no backoff, a failure is a row
    env["ILQG_BENCH_BACKOFF"] = cfg.get("backoff", "0")
    t0 = time.time()
    try:
        p = subprocess.run(command(device), env=env, cwd=ROOT,
                           capture_output=True, text=True,
                           timeout=float(cfg.get("timeout", 1500)))
        line = next((ln for ln in reversed(p.stdout.splitlines())
                     if ln.startswith("{")), None)
        row = json.loads(line) if line else {}
        if p.returncode != 0 or not row:
            text = " ".join(row.get("errors", [])) + p.stderr + p.stdout
            row["error"] = ("out of memory" if "out of memory" in text.lower()
                            else text[-300:])
        peak = PEAK.search(p.stderr)
        row["peak_gib"] = float(peak.group(1)) if peak else None
        graphs = GRAPHS.search(p.stderr)
        row["graph_gib"] = float(graphs.group(1)) if graphs else None
    except subprocess.TimeoutExpired:
        row = {"error": "timeout", "peak_gib": None, "graph_gib": None}
    row["config"] = cfg
    row["wall_s"] = round(time.time() - t0, 1)
    return row


def expand(cfg, rows_so_far):
    """The batches of ``cfg``'s rows: its own, or with ``doubling`` the
    next doubling while every earlier row of it ran."""
    if not cfg.get("doubling"):
        return None if rows_so_far else cfg.get("batch", 0)
    if rows_so_far and "error" in rows_so_far[-1]:
        return None
    return cfg["batch"] * 2 ** len(rows_so_far)


def sweep(configs, env_name, reps, trials, device, out=None):
    """Every row of ``configs``, printed as it ends and appended to the
    file ``out``; returns the rows."""
    rows = []
    for cfg in configs:
        mine = []
        while (batch := expand(cfg, mine)) is not None:
            row_cfg = {k: v for k, v in cfg.items() if k != "doubling"}
            row_cfg["batch"] = batch
            row = run_one(env_name, row_cfg, reps, trials, device)
            mine.append(row)
            print(json.dumps(row), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
        rows += mine
    return rows


def table(rows, env_name="pendulum"):
    """The markdown table of ``rows``."""
    out = ["| env | B | mode+engine | chunk_knots | iters/s (headline) | "
           "trial min/median/max | peak GiB | GiB per instance | wall s | "
           "note |", "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        c = r["config"]
        me = f"{c.get('mode', 'tassa')}+{c.get('engine', 'ad')}"
        env = c.get("env", env_name)
        # the bench line's; a failed row's, the one its bench picked
        chunk = r.get("chunk_knots", c["chunk"] if "chunk" in c
                      else auto_chunk(env, c.get("batch", 0)))
        head = (f"| {env} | {c.get('batch')} | {me} | "
                f"{'none' if chunk is None else chunk} |")
        if "error" in r:
            out.append(f"{head} FAILED | | | | {r['wall_s']} | "
                       f"{r['error'][:60]} |")
            continue
        s, peak = r.get("spread", {}), r.get("peak_gib")
        per = f"{peak / c['batch']:.4g}" if peak is not None else "—"
        out.append(f"{head} {r['value']:.4g} | {s.get('min', 0):.4g} / "
                   f"{s.get('median', 0):.4g} / {s.get('max', 0):.4g} | "
                   f"{'—' if peak is None else peak} | {per} | "
                   f"{r['wall_s']} | vs_baseline={r.get('vs_baseline')} |")
    return "\n".join(out)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="pendulum")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--configs", default=None,
                    help="JSON list of config dicts (overrides the default "
                         "sweep)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    configs = json.loads(args.configs) if args.configs else DEFAULT_SWEEP
    rows = sweep(configs, args.env, args.reps, args.trials, dev, args.out)
    print()
    print(table(rows, args.env))
    return 1 if all("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
