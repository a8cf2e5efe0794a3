"""batch_p95_ms is a tail over every batch of the window, and qps counts
only what reached the host before the window closed."""
import numpy as np
import pytest

from bench.harness import runner
from bench.harness.window import Window


def window_of(latencies_ms, step_ms=8.0, seconds=1.0):
    w = Window(setup_s=1.0, seconds=seconds)
    t = 0.0
    for lat in latencies_ms:
        w.t_dispatch.append(t)
        w.t_done.append(t + lat / 1e3)
        w.pool_index.append(0)
        t += step_ms / 1e3
    w.t_end = seconds
    return w


def test_p95_is_over_all_batches_so_one_stall_moves_it():
    steady = [17.0] * 19
    stalled = [17.0] * 18 + [60.0]
    base = runner.end_to_end(window_of(steady), 2048)["batch_p95_ms"]
    hit = runner.end_to_end(window_of(stalled), 2048)["batch_p95_ms"]
    assert base == pytest.approx(17.0)
    assert hit == pytest.approx(float(np.percentile(stalled, 95)))
    assert hit > base + 4.0
    # a median of per-chunk p95s would not see it
    chunks = [np.percentile(stalled[i:i + 5], 95) for i in range(0, 15, 5)]
    assert np.median(chunks) == pytest.approx(17.0)


def test_qps_counts_batches_done_inside_the_window():
    w = window_of([17.0] * 10, step_ms=100.0, seconds=1.0)
    w.t_done[-1] = 1.5                   # completes after the close
    e2e = runner.end_to_end(w, 2048)
    assert e2e["qps"] == 9 * 2048 / 1.0
    assert e2e["setup_s"] == 1.0
