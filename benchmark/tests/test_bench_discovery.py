"""The harness finds every cell, configuration, traffic mix and metric by
name, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    found = harness.find_cell(BENCH, cell)
    assert found["cell"]["name"] == cell
    assert found["config_file"]["config"]
    driver = harness.driver(found["traffic"]["kind"])
    for fn in ("setup", "step", "full", "end_to_end", "outcome",
               "trace_begin", "trace_end", "release", "check", "control"):
        assert callable(getattr(driver, fn)), fn
    names = {m["name"] for m in found["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert found["per_layer"]
    assert os.path.exists(os.path.join(harness.HERE, "limits",
                                       f"{cell}.json"))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric))


def test_unknown_cell_is_refused():
    with pytest.raises(harness.Refused):
        harness.find_cell(BENCH, "no.such_cell")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][0] == "python3"
    assert all(p == "benchmark" or p.startswith("benchmark/")
               for p in BENCH["command"][1:2])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m.get("workloads", moved)) <= set(moved)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_check_budget_fits_with_24_cells():
    run = BENCH["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (run + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_source_cuts_and_assumptions(config):
    with open(os.path.join(harness.ROOT, config["file"])) as f:
        body = json.load(f)
    assert body["source"] and body["assumed"]["scene"]
    assert sorted(body["reduced"]) == sorted(config["reduced"])
