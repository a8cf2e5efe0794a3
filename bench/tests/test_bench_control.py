"""The control, the reference one precision step below the configuration
(rows in bfloat16, products in TF32), put in the program's place, comes
out not correct under each cell's limits; the program itself does not.

On the chip `bench/calibrate.py` takes these readings at each cell's own
size; here they are taken at a tiny size on the CPU, where TF32 does not
exist and the bfloat16 rows alone must fail the check.
"""
import time

import pytest
import torch

from bench.harness import check, runner, spec
from bench.tests.conftest import tiny_cell

CELLS = [w["name"] for w in
         spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("limits", CELLS)
def test_control_fails_program_passes(limits):
    cell = tiny_cell(limits=limits)
    model, inputs, window, _ = runner.open_window(
        cell, 5, 0.2, False, torch.device("cpu"), time.perf_counter())
    ref = runner.reference_outputs(model, cell.config, inputs, window)
    ctl = runner.reference_outputs(model, cell.config, inputs, window,
                                   lower=True)
    ok, _ = check.judge(check.readings(window, ref), cell.limits)
    assert ok
    values = check.readings(check.control_window(window, ctl), ref)
    ok, judged = check.judge(values, cell.limits)
    assert not ok
    assert values["pooled_gap"] > cell.limits["pooled_gap"]["limit"]
