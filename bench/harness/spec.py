"""Finds a cell's parts by the names in `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, model, driver
or per-layer metric sits in a file of its own under `bench/`:

    configs/<config>.json     sizes of a configuration, as run
    traffic/<traffic>.json    parameters of a traffic mix
    limits/<workload>.json    the correctness limits of a cell
    models/<model>.py         inputs, program and work counts of a model
    drivers/<driver>.py       the loop that offers a mix's load
    metrics/<metric>.py       the reader of one per-layer metric

so a later change that adds a cell adds files and entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """`bench/<kind>/<name>.py` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    key = f"bench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def load_cell(workload: str, benchmark: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    spec = load_json(benchmark)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(ROOT / configs[w["config"]]["file"])
    cell = Cell(name=workload, chips=int(w["chips"]),
                config_name=w["config"], config=cfg,
                traffic_name=w["traffic"],
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH / "limits" / f"{workload}.json"),
                end_to_end=[], per_layer=[])
    cell.end_to_end = [m for m in spec["end_to_end"] if cell.reports(m)]
    cell.per_layer = [m for m in spec["per_layer"] if cell.reports(m)]
    return cell
