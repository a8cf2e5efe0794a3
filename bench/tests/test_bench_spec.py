"""BENCHMARK.json keeps to the shape the driver checks, and every name in
it finds its file under bench/."""
import json
import re

import pytest

from bench.harness import spec

B = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench"] and B["command"][1] == "bench/run.py"
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


def test_names_units_and_lines():
    for c in B["configs"]:
        assert NAME.match(c["name"]) and set(c) == {
            "name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    for w in B["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = B["end_to_end"] + B["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert {m["name"] for m in B["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_parts(w):
    cell = spec.load_cell(w["name"])
    spec.load_module("models", cell.config["model"])
    spec.load_module("drivers", cell.traffic["driver"])
    assert set(cell.limits) == {"logit_gap", "pooled_gap", "missing"}
    assert cell.end_to_end and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
