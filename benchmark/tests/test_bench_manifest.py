"""BENCHMARK.json against the benchmark's contract: names, units and
characters, every cell resolving to its files, every metric to a reader."""
import json
import re

import pytest

from benchmark import harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
METRICS = M["end_to_end"] + M["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in M["paths"])
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M).encode()) <= 64 * 1024


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_names_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert harness.reader_path(metric["name"]).exists()
    cells = {c["name"] for c in M["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in M["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        e2e = {m["name"]: m for m in M["end_to_end"]}
        assert metric["moves"] in e2e
        moved = e2e[metric["moves"]]
        assert set(metric.get("workloads", cells)) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert cell["chips"] in (1, 4)
    c, config, traffic, limits = harness.resolve(M, cell["name"])
    assert config["name"] == cell["config"]
    assert (harness.ROOT / "drivers" / f"{traffic['request']}.py").exists()
    e2e = [m["name"] for m in harness.cell_metrics(M, cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(M, cell["name"], True)
    assert limits["limits"] and all(isinstance(v, float) for v in limits["limits"].values())
    for name, limit in limits["limits"].items():
        # between the readings, with more room above the lower
        lower, upper = limits["readings"][name]["lower"], limits["readings"][name]["upper"]
        assert lower < limit < upper and limit / lower > upper / limit


@pytest.mark.parametrize("entry", M["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert entry["file"].startswith(M["paths"][0] + "/")
    config = harness.load_json(harness.REPO / entry["file"])
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == []
    files = [e["file"] for e in M["configs"]]
    assert files.count(entry["file"]) == 1
    assert any(c["config"] == entry["name"] for c in M["workloads"])


def test_setup_bound_and_chip_cells():
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    four = [c for c in M["workloads"] if c["chips"] == 4]
    assert len(four) <= max(1, len(M["workloads"]) // 4)
