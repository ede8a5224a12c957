"""Shared pieces of the benchmark's own tests: a cell cut to a size the
CPU runs in seconds, and one run of it with its output lines."""

import io
import json
import time

import pytest

from benchmark import harness


def tiny(spec):
    """A cell cut for the CPU: a batch of 2, a short horizon, 2
    iterations; the program and the reference both read the cut
    configuration."""
    spec.conf["horizon"] = 5
    spec.conf["iterations"] = 2
    spec.conf["warm_steps"] = min(spec.conf["warm_steps"], 2)
    if spec.traffic["kind"] == "solve":
        spec.traffic.update(batch=2, pool=2)
        spec.traffic["check"].update(solves=2, per_solve=2, device="cpu")


def run_cell(workload, seed=2 ** 31 + 77, trace=False, solver=None,
             tweak=tiny):
    """(rc, last stdout line as a dict or None, stderr lines)."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, seed, 0.0, trace, time.perf_counter(),
                     device="cpu", solver=solver, tweak=tweak, out=out,
                     err=err)
    lines = out.getvalue().strip().splitlines()
    return (rc, json.loads(lines[-1]) if lines else None,
            err.getvalue().strip().splitlines())


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"
