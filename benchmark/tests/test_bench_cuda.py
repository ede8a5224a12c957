"""On the card: a cell cut to a test's size runs correct, and the traced
iteration finds device work, the kernel among it.  Skips without a card
(``python -m pytest benchmark/tests -m cuda`` on one)."""

import io
import json
import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cartpole_solve_b16384", "cartpole_mpc_b1"])
def test_traced_cell_on_the_card(cell, cuda_device):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, 2 ** 31 + 123, 0.0, True, time.perf_counter(),
                     device=cuda_device, tweak=tiny, out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    name = "launches_per_iter." + ("solve" if "solve" in cell else "mpc")
    assert line["metrics"][name]["value"] > 0
    if "solve" in cell:
        assert 0 < line["metrics"]["riccati_roofline.solve"]["value"] <= 100
