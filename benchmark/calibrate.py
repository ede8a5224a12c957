"""Readings for a cell's correctness limits, several seeds in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 0

The control: the reference in float32 (TF32 off) stands in the program's
place at the cell's own batch, and the reference in the configuration's
float64 judges it.  Each seed is one run of ``harness.run`` with
``--trace 0``, its result line printed as it comes; the readings are the
upper ones a limit must stay under.  Not run by the benchmark's runs.
"""

import time

T0 = time.perf_counter()

import argparse   # noqa: E402
import functools  # noqa: E402
import pathlib    # noqa: E402
import sys        # noqa: E402

sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    import torch
    from benchmark import harness
    kind = harness.kind(harness.load_spec(args.workload).traffic["kind"])
    solver = functools.partial(kind.Control, dtype=torch.float32)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        rc |= harness.run(args.workload, seed, args.seconds, False, t,
                          device=args.device, solver=solver)
        print(f"seed {seed} took {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
