"""Run one cell of the benchmark once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for.  Prints the cell's metrics as one JSON line last on standard
output (its end-to-end metrics, or with ``--trace 1`` its per-layer ones),
and the numbers of the correctness check, each with its limit, as the last
lines on standard error.  Exits with another code than 0, and prints no
result, without enough CUDA devices or if the process has loaded JAX or the
JAX package.
"""

import time

T0 = time.perf_counter()   # set-up is timed from the start of the process

import argparse   # noqa: E402
import pathlib    # noqa: E402
import sys        # noqa: E402

# the checkout's root, so that the program and this package import
sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness
    return harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
