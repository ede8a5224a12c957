"""BENCHMARK.json and the files it names: the contract's shape, and each
cell's configuration, traffic mix, limits and metric readers found by
name."""

import json
import re

import pytest

from benchmark import harness, run

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 and cells <= 24


@pytest.mark.parametrize("entry", METRICS + BENCH["configs"]
                         + BENCH["workloads"], ids=lambda e: e["name"])
def test_names_units_and_keys(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        allowed = {"name", "unit", "better", "source", "workloads"}
        if entry in BENCH["end_to_end"]:
            allowed |= {"bound"}
            assert entry["source"] in ("host_clock", "device_trace")
            assert 0.01 <= entry["bound"] <= 0.25
        else:
            allowed |= {"layer", "moves"}
            assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert set(entry) <= allowed
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


def test_names_unique():
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    spec = harness.load_spec(cell)
    k = harness.kind(spec.traffic["kind"])
    assert spec.conf["name"] == spec.cell["config"]
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.reader(m["name"]))
    assert {"cost", "traj", "gain"} <= set(spec.limits)
    for number in spec.limits.values():
        assert number["lower"] < number["limit"] < number["upper"]
    for name in ("Program", "Control", "Loop"):
        assert isinstance(getattr(k, name), type)


@pytest.mark.parametrize("metric", [m for m in BENCH["per_layer"]],
                         ids=lambda m: m["name"])
def test_per_layer_only_where_its_end_to_end_metric_is(metric):
    for cell in metric["workloads"]:
        names = {m["name"] for m in harness.load_spec(cell).end_to_end}
        assert metric["moves"] in names


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.load_spec("no_such_cell")
    with pytest.raises(KeyError):
        harness.kind("../run")


def test_arguments():
    a = run.parse(["--workload", "x", "--seed", str(2 ** 31 + 5),
                   "--seconds", "51", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x", 2 ** 31 + 5,
                                                        51.0, 1)
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x", "--seed", "1", "--seconds", "1",
                   "--trace", "2"])
