"""The port's embedding-stage planner against the TPU path's, and the
quickstart that runs it.

Where neither package's on-chip budget binds (the TPU path's VMEM, the
port's L2), both pick the same pinned rows, coverage, ring depth and
notes from the same trace; the port's L2 budget binds at
`hot_cache.l2_budget_rows`.
"""
import numpy as np
import pytest

from repro.core import make_pattern as jmake_pattern
from repro.core import plan_embedding_stage as jplan
from repro_torch.core import (EmbeddingPlanReport, l2_budget_rows,
                              make_pattern, plan_embedding_stage)
from repro_torch.examples import quickstart
from repro_torch.kernels.embedding_bag.kernel import (RING_DEPTHS,
                                                      LaunchGeometry)

SHARED = ("hotness_unique_pct", "hot_coverage_at_k", "pinned_rows",
          "prefetch_distance", "batch_block", "latency_bound", "notes")


@pytest.mark.parametrize("hotness", ["one_item", "high_hot", "med_hot",
                                     "low_hot", "random"])
@pytest.mark.parametrize("dim", [64, 128])
def test_report_equals_jax_where_no_budget_binds(hotness, dim):
    rows = 4096
    trace = make_pattern(hotness, rows, seed=2).sample(128, 20, seed=1)
    np.testing.assert_array_equal(
        trace, jmake_pattern(hotness, rows, seed=2).sample(128, 20, seed=1))
    got, want = plan_embedding_stage(trace, rows, dim), jplan(trace, rows,
                                                              dim)
    assert got.pinned_rows < l2_budget_rows(dim)
    for field in SHARED:
        assert getattr(got, field) == getattr(want, field), field
    assert got.l2_pinned_bytes == got.pinned_rows * dim * 4
    assert got.shared_memory_bytes == LaunchGeometry(
        prefetch_distance=got.prefetch_distance,
        batch_block=got.batch_block).shared_bytes(dim, 4)
    assert not hasattr(got, "vmem_bytes")


def test_planner_report():
    """tests/test_core.py::test_planner_report on the port."""
    pat = make_pattern("high_hot", 4096, seed=1)
    trace = pat.sample(128, 20)
    rep = plan_embedding_stage(trace, 4096, dim=128)
    assert isinstance(rep, EmbeddingPlanReport)
    assert rep.latency_bound
    assert rep.pinned_rows > 0
    assert 2 <= rep.prefetch_distance <= 16
    assert rep.hot_coverage_at_k > 0.4

    flat = make_pattern("random", 4096, seed=1).sample(128, 20)
    rep2 = plan_embedding_stage(flat, 4096, dim=128)
    # a flat trace needs far more pinned rows than a hot one for the same
    # coverage target
    assert rep2.pinned_rows > 5 * rep.pinned_rows


def test_l2_budget_binds_at_l2_budget_rows():
    dim = 65536                   # 256 KiB rows: the L2 budget holds 143
    budget = l2_budget_rows(dim)
    assert budget == 143
    trace = make_pattern("random", 4096, seed=3).sample(128, 20, seed=0)
    rep = plan_embedding_stage(trace, 4096, dim)
    assert rep.pinned_rows == budget
    assert rep.l2_pinned_bytes == budget * dim * 4
    # the TPU path clamps to its VMEM budget instead, and its ring to 1 MiB
    want = jplan(trace, 4096, dim)
    assert want.pinned_rows > budget and want.prefetch_distance == 4
    lo, hi = RING_DEPTHS
    assert lo <= rep.prefetch_distance <= hi
    # below the budget the coverage rule decides, as on the TPU path
    small = plan_embedding_stage(trace, 4096, 128)
    assert small.pinned_rows == jplan(trace, 4096, 128).pinned_rows < \
        l2_budget_rows(128)


def test_low_reuse_disables_pinning_and_deepens_the_ring():
    """2,000 distinct rows: the 143 rows the L2 budget holds at D=65536
    cover 7 % of the accesses, under the 10 % floor."""
    trace = np.arange(2000, dtype=np.int32).reshape(100, 20)
    rep = plan_embedding_stage(trace, 100_000, 65536)
    assert (rep.pinned_rows, rep.hot_coverage_at_k) == (0, 0.0)
    assert rep.notes == ("low reuse: pinning covers <10% of accesses; "
                         "disabled",)
    assert rep.prefetch_distance == RING_DEPTHS[1]


def test_quickstart_runs_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["max_abs_err"] < quickstart.MAX_ERR
    assert out["report"].pinned_rows > 0
    printed = capsys.readouterr().out
    assert printed.startswith("planner: pin ")
    assert printed.rstrip().endswith("OK")
