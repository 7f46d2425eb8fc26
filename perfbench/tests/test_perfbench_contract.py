"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file."""

import json
import os
import re

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.benchmark()


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert b["command"][1] == "perfbench/run.py"
    assert os.path.isfile(os.path.join(harness.ROOT, b["command"][1]))
    assert len(json.dumps(b)) < 64 * 1024


def test_configs_cells_and_metrics_are_well_formed():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    names = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        e2e, layer = harness.metrics_of(b, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer
        # a per-layer metric's cells report the metric it moves
        assert all(m["moves"] in names for m in layer)


def test_every_name_is_found_as_a_file():
    b = bench()
    for w in b["workloads"]:
        cell = harness.load_json("workloads", f"{w['name']}.json")
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        harness.load_json("traffic", f"{w['traffic']}.json")
        assert hasattr(harness.load_module("drivers", cell["driver"]), "make")
    for m in b["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
