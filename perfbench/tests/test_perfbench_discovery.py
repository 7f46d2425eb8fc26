"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files only, found by name by the harness that exists."""

import json
import os
import shutil

from perfbench import harness
from perfbench.tests import tiny


def test_a_fixture_cell_added_as_files_only(tmp_path, monkeypatch):
    copy = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(copy, p), "rb").read()
              for p in ("harness.py", "drivers/ilql.py", "readers.py")}
    # the new files: a configuration, a traffic mix, a cell, a metric
    config = json.load(open(copy / "configs" / "gpt2-124m.json"))
    config.update(name="fixture-model", spec=tiny.GPT2)
    json.dump(config, open(copy / "configs" / "fixture-model.json", "w"))
    json.dump({"lengths": {"dist": "fixed", "value": 12}},
              open(copy / "traffic" / "fixture_rows.json", "w"))
    cell = json.load(open(copy / "workloads" / "ilql-gpt2-imdb.json"))
    cell.update(config="fixture-model", traffic="fixture_rows",
                why="a fixture: every row 12 tokens")
    json.dump(cell, open(copy / "workloads" / "fixture-cell.json", "w"))
    (copy / "metrics" / "fixture.updates.py").write_text(
        "def read(r):\n    return float(len(r.ctx.span_times("
        "'ilql.update')))\n")
    bench = harness.benchmark()
    bench["configs"].append({"name": "fixture-model", "source": "fixture",
                             "file": "perfbench/configs/fixture-model.json",
                             "reduced": [], "why": "a fixture"})
    bench["workloads"].append({"name": "fixture-cell",
                               "config": "fixture-model",
                               "traffic": "fixture_rows", "chips": 1,
                               "why": cell["why"]})
    for m in bench["end_to_end"]:
        if m["name"] == "ilql_tokens_per_s":
            m["workloads"].append("fixture-cell")
    bench["per_layer"].append({
        "name": "fixture.updates", "unit": "updates", "better": "higher",
        "source": "host_clock", "layer": "ILQL trainer",
        "moves": "ilql_tokens_per_s", "workloads": ["fixture-cell"]})
    path = tmp_path / "BENCHMARK.json"
    json.dump(bench, open(path, "w"))

    monkeypatch.setattr(harness, "HERE", str(copy))
    monkeypatch.setitem(tiny.OVERRIDES, "fixture-cell", {
        k: v for k, v in tiny.OVERRIDES["ilql-gpt2-imdb"].items()
        if k not in ("spec", "traffic_params")})
    rc, line = tiny.run("fixture-cell", trace=1, bench_path=str(path))
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["fixture.updates"]["value"] > 0
    rc, line = tiny.run("fixture-cell", trace=0, bench_path=str(path))
    assert set(line["metrics"]) == {"ilql_tokens_per_s", "setup_s"}
    for p, data in before.items():  # nothing that was there was edited
        assert open(os.path.join(copy, p), "rb").read() == data
