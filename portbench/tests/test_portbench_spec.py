"""BENCHMARK.json against the benchmark's files: every cell, configuration
and metric found by name; names and units within the character rules."""

from __future__ import annotations

import json

import pytest

from portbench.harness import check, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.traffic["chips"] == cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "step_ms"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(cell.metric_module(m).read)
    assert cell.traffic["limits"] and set(cell.traffic["limits"]) <= set(check.NUMBERS)


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        record = json.loads((spec.ROOT / c["file"]).read_text())
        assert record["name"] == c["name"] and record["source"] == c["source"]
        assert record["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(set(names)) == len(names)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200


@pytest.mark.parametrize("name", [
    *(w["name"] for w in BENCH["workloads"]), *(m["name"] for m in BENCH["per_layer"]),
    *(m["name"] for m in BENCH["end_to_end"]), *(c["name"] for c in BENCH["configs"]), "mfu.train", "_x-1",
])
def test_names_keep_to_the_rules(name):
    assert spec.check_name(name) == name


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", ".x", "-x", "x" * 65, "µs", "é"])
def test_bad_names_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)


@pytest.mark.parametrize("unit", [*sorted({m["unit"] for m in BENCH["per_layer"] + BENCH["end_to_end"]}), "tokens/s"])
def test_units_keep_to_the_rules(unit):
    assert spec.check_unit(unit) == unit


@pytest.mark.parametrize("bad", ["", "tokens per second", "µs", "x" * 17])
def test_bad_units_refused(bad):
    with pytest.raises(ValueError):
        spec.check_unit(bad)


@pytest.mark.parametrize("listed", [None, [CELLS[-1]]])
def test_every_cell_runs_every_metric_reader(listed):
    """A new metric is a new entry and a new reader, whatever cells it
    lists: the reader decides where it has something to read."""
    bench = json.loads(json.dumps(BENCH))
    metric = {"name": "new_metric", "unit": "%", "better": "higher", "source": "device_trace",
              "layer": "dense ops", "moves": "step_ms"}
    if listed is not None:
        metric["workloads"] = listed
    bench["per_layer"].append(metric)
    cell = spec.load_cell(CELLS[0], bench)
    assert [m["name"] for m in cell.per_layer] == [m["name"] for m in bench["per_layer"]]
    with pytest.raises(FileNotFoundError):
        cell.metric_module(cell.per_layer[-1])
