"""BENCHMARK.json and the files its names resolve to."""
import json
import re

import pytest

from bench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    """Each cell finds its configuration, traffic, driver, limits and
    metric readers by name, and reports setup_s, another end-to-end
    metric and a per-layer metric that moves one it reports."""
    wl = harness.Workload(cell, BENCH)
    assert wl.config["name"] == wl.cell["config"]
    assert set(wl.config_entry["reduced"]) == set(wl.config["reduced"])
    assert hasattr(wl.kind(), "run")
    assert wl.limits
    names = {m["name"] for m in wl.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert wl.per_layer
    for m in wl.per_layer:
        assert m["moves"] in names
        assert hasattr(wl.metric_reader(m["name"]), "read")


def test_every_metric_and_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
