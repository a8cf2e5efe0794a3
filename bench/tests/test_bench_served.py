"""The `served` driver, rehearsed on the CPU at a tiny size: every batch
goes through `ServingSession.submit_batch` and `poll`, one queued ahead,
and every logit that comes back is checked."""
from bench.tests.conftest import run_tiny, tiny_cell


def test_served_driver_runs_a_correct_window():
    out = run_tiny(tiny_cell(driver="served"), seed=13, seconds=0.3)
    r, side = out["result"], out["side"]
    assert r["correct"] is True and r["failed"] == 0
    assert side["batches"] >= 16 and len(side["held"]) == 2
    assert r["metrics"]["qps"]["value"] > 0
    assert side["batch_ms"][50] <= side["batch_ms"][95]
