"""Tests of the benchmark, on the CPU at tiny sizes; those marked `cuda`
run the kernels and skip where no card is present (decided in the
`cuda_device` fixture, never at import).

    python -m pytest -q bench/tests            # from the repository root
"""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import spec  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where none is present")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the kernels on the card")
    return torch.device("cuda", 0)


TINY = dict(num_tables=5, rows=1000, dim=16, pooling=7, dense_features=13,
            bottom_mlp=[32, 16], top_mlp=[32, 8, 1])


def tiny_cell(traffic: str = "med_hot", driver: str = "step",
              limits: str = "dlrm-production.med_hot", batch: int = 64,
              **config) -> spec.Cell:
    """A cell of the production configuration cut to a CPU test's size,
    held to a real cell's limits."""
    cfg = spec.load_json(spec.BENCH / "configs" / "dlrm-production.json")
    cfg.update(TINY, **config)
    tr = spec.load_json(spec.BENCH / "traffic" / f"{traffic}.json")
    tr.update(batch=batch, driver=driver)
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    return spec.Cell(
        name="tiny", chips=1, config_name="tiny", config=cfg,
        traffic_name=traffic, traffic=tr,
        limits=spec.load_json(spec.BENCH / "limits" / f"{limits}.json"),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def run_tiny(cell, seed=7, seconds=0.3, device="cpu", trace=False):
    from bench.harness import runner
    return runner.run_cell(cell, seed, seconds, trace, torch.device(device),
                           time.perf_counter())


@pytest.fixture(autouse=True)
def _side_records(tmp_path, monkeypatch):
    """Keep each test's side records and traces under its tmp_path."""
    from bench.harness import runner
    monkeypatch.setattr(runner, "OUT", tmp_path / "bench")
