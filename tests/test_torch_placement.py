"""The port's `storage/placement.py` and the shard planners of `core/plan.py`
against the JAX package: load estimates, LPT placements with and without
replication, migration plans, replica routing, and the sharded backend's
pure helpers (`_chunk_bounds`, `merge_shard_stats`) — each output equal to
the JAX package's exactly, on the same numpy traces.

Mirrors tests/test_placement.py and tests/test_migration.py (the planner
and router cases); the backend cases are tests/test_torch_sharded.py.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import make_pattern as jmake_pattern
from repro.core import plan as jplan
from repro.storage import placement as jplacement
from repro.storage import sharded as jsharded
from repro_torch.core import plan
from repro_torch.core.access_patterns import make_pattern
from repro_torch.storage import placement
from repro_torch.storage import sharded

ROWS, TABLES, POOL = 256, 6, 6
ROW_BYTES = 16 * 4
# heavy tables stacked at one end: the contiguous split starts lopsided
SKEWED = ("one_item", "one_item", "high_hot", "med_hot", "random", "random")


def _trace(hotness=SKEWED, batches=3, batch=8, seed0=50):
    pats = [make_pattern(h, ROWS, seed=t) for t, h in enumerate(hotness)]
    return np.concatenate([
        np.stack([p.sample(batch, POOL, seed=(seed0 + s) * 100 + t)
                  for t, p in enumerate(pats)], axis=1).astype(np.int32)
        for s in range(batches)], axis=0)


def _same(port, ref):
    """A port placement equals the JAX one field for field."""
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.shard_tables == ref.shard_tables
    assert port.replicated_tables == ref.replicated_tables
    np.testing.assert_array_equal(port.shard_loads, ref.shard_loads)
    assert port.imbalance_ratio() == ref.imbalance_ratio()
    assert port.describe() == ref.describe()


def _to_jax(plc):
    return jplacement.ShardPlacement(**dataclasses.asdict(plc))


def test_access_patterns_are_the_reference_copy():
    for t, h in enumerate(SKEWED):
        np.testing.assert_array_equal(
            make_pattern(h, ROWS, seed=t).sample(8, POOL, seed=3),
            jmake_pattern(h, ROWS, seed=t).sample(8, POOL, seed=3))


@pytest.mark.parametrize("hotness", [SKEWED, ("med_hot",) * 4,
                                     ("random", "one_item")])
def test_estimate_table_loads_equals_jax(hotness):
    trace = _trace(hotness)
    for row_bytes in (1, ROW_BYTES):
        np.testing.assert_array_equal(
            placement.estimate_table_loads(trace, row_bytes),
            jplacement.estimate_table_loads(trace, row_bytes))
    # a one-table [N, L] trace
    np.testing.assert_array_equal(
        placement.estimate_table_loads(trace[:, 0]),
        jplacement.estimate_table_loads(trace[:, 0]))


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 64])
def test_contiguous_placement_equals_jax(num_shards):
    loads = placement.estimate_table_loads(_trace(), ROW_BYTES)
    _same(placement.ShardPlacement.contiguous(TABLES, num_shards, loads),
          jplacement.ShardPlacement.contiguous(TABLES, num_shards, loads))
    _same(placement.ShardPlacement.contiguous(TABLES, num_shards),
          jplacement.ShardPlacement.contiguous(TABLES, num_shards))


@pytest.mark.parametrize("num_shards,replicate_factor,max_replicas", [
    (2, 0.0, None), (3, 0.0, None), (3, 1.0, None), (4, 0.5, None),
    (3, 0.3, 2), (64, 0.0, None)])
def test_plan_shard_placement_equals_jax(num_shards, replicate_factor,
                                         max_replicas):
    """The LPT planner, with and without the replication escape hatch;
    the planner-API wrappers of `core.plan` answer the same."""
    trace = _trace()
    kw = dict(row_bytes=ROW_BYTES, replicate_factor=replicate_factor,
              max_replicas=max_replicas)
    want = jplacement.plan_shard_placement(trace, num_shards, **kw)
    _same(placement.plan_shard_placement(trace, num_shards, **kw), want)
    _same(plan.plan_shard_placement(trace, num_shards, **kw), want)
    _same(plan.plan_shard_placement(trace, num_shards, **kw),
          jplan.plan_shard_placement(trace, num_shards, **kw))


def test_balanced_beats_contiguous_and_replicates_dominant_table():
    trace = _trace()
    loads = placement.estimate_table_loads(trace, ROW_BYTES)
    cont = placement.ShardPlacement.contiguous(TABLES, 2, loads=loads)
    bal = placement.plan_shard_placement(trace, 2, row_bytes=ROW_BYTES)
    assert bal.imbalance_ratio() < 1.1 < cont.imbalance_ratio()
    outlier = np.array([100.0, 5.0, 5.0, 5.0])
    for mod in (placement, jplacement):
        plc = mod.plan_shard_placement(None, 3, loads=outlier,
                                       replicate_factor=1.0)
        assert plc.replicated_tables == (0,)
        assert len(set(plc.replicas[0])) == len(plc.replicas[0]) >= 2
    _same(placement.plan_shard_placement(None, 3, loads=outlier,
                                         replicate_factor=1.0),
          jplacement.plan_shard_placement(None, 3, loads=outlier,
                                          replicate_factor=1.0))


@pytest.mark.parametrize("kw,match", [
    (dict(num_tables=2, num_shards=2, replicas=((0,), ()),
          loads=(1.0, 1.0)), "no shard"),
    (dict(num_tables=1, num_shards=2, replicas=((0, 0),), loads=(1.0,)),
     "twice"),
    (dict(num_tables=1, num_shards=2, replicas=((5,),), loads=(1.0,)),
     "unknown shard"),
    (dict(num_tables=2, num_shards=1, replicas=((0,),), loads=(1.0,)),
     "one entry per table")])
def test_shard_placement_validation_equals_jax(kw, match):
    errors = []
    for mod in (placement, jplacement):
        with pytest.raises(ValueError, match=match) as e:
            mod.ShardPlacement(**kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    for mod in (placement, jplacement):
        with pytest.raises(ValueError, match="num_shards"):
            mod.plan_shard_placement(_trace(), 0)


@pytest.mark.parametrize("old,threshold,replicate_factor", [
    ("contiguous", 1.1, 0.0), ("contiguous", 10.0, 0.0),
    ("balanced", 1.0, 0.0), ("one_shard", 1.0, 0.0),
    ("contiguous", 1.1, 0.5)])
def test_plan_migration_equals_jax(old, threshold, replicate_factor):
    """The threshold and gain gates, and the plan itself (moved tables,
    replica changes, imbalance before and after, the new placement)."""
    trace = _trace()
    loads = placement.estimate_table_loads(trace, ROW_BYTES)
    plc = {"contiguous": placement.ShardPlacement.contiguous(
               TABLES, 2, loads=loads),
           "balanced": placement.plan_shard_placement(
               trace, 2, row_bytes=ROW_BYTES),
           "one_shard": placement.ShardPlacement.contiguous(
               TABLES, 1, loads=loads)}[old]
    kw = dict(row_bytes=ROW_BYTES, threshold=threshold,
              replicate_factor=replicate_factor)
    got = placement.plan_migration(plc, trace, **kw)
    want = jplacement.plan_migration(_to_jax(plc), trace, **kw)
    via_plan = plan.plan_shard_migration(plc, trace, **kw)
    assert (got is None) == (want is None) == (via_plan is None)
    if old == "contiguous" and threshold < 2:
        assert got is not None and got.moved_tables
    if got is None:
        return
    for g in (got, via_plan):
        assert g.moved_tables == want.moved_tables
        assert g.replica_changes == want.replica_changes
        assert g.imbalance_before == want.imbalance_before
        assert g.imbalance_after == want.imbalance_after
        assert g.describe() == want.describe()
        _same(g.new, want.new)
        _same(g.old, want.old)


def test_plan_migration_can_change_replica_count_like_jax():
    loads = np.array([100.0, 5.0, 5.0, 5.0])
    old = dict(num_tables=4, num_shards=3,
               replicas=((0,), (1,), (2,), (0,)), loads=tuple(np.ones(4)))
    got = placement.plan_migration(placement.ShardPlacement(**old), None,
                                   loads=loads, threshold=1.2,
                                   replicate_factor=1.0)
    want = jplacement.plan_migration(jplacement.ShardPlacement(**old),
                                     None, loads=loads, threshold=1.2,
                                     replicate_factor=1.0)
    assert 0 in got.replica_changes and len(got.new.replicas[0]) > 1
    assert got.replica_changes == want.replica_changes
    _same(got.new, want.new)
    with pytest.raises(ValueError, match="trace"):
        placement.plan_migration(placement.ShardPlacement(**old), None)


def _costs(seed, n, steps):
    rng = np.random.default_rng(seed)
    costs = rng.exponential(1.0, size=(steps, n)) * np.linspace(1, 8, n)
    costs[rng.random((steps, n)) < 0.15] = np.nan     # replica served none
    return costs


@pytest.mark.parametrize("n,alpha,min_frac,tol", [
    (2, 0.5, 0.05, 0.02), (3, 0.5, 0.05, 0.02), (4, 0.3, 0.1, 0.0),
    (32, 0.5, 0.05, 0.02), (2, 1.0, 0.0, 0.05)])
def test_replica_router_equals_jax(n, alpha, min_frac, tol):
    """Every observation's published-split decision, fractions and
    bounds at several batch sizes, including batches below the replica
    count."""
    port = placement.ReplicaRouter(n, alpha=alpha, min_frac=min_frac)
    ref = jplacement.ReplicaRouter(n, alpha=alpha, min_frac=min_frac)
    assert port.min_frac == ref.min_frac
    for costs in _costs(n, n, 12):
        assert port.observe(costs, tol=tol) == ref.observe(costs, tol=tol)
        np.testing.assert_array_equal(port.fractions(), ref.fractions())
        np.testing.assert_array_equal(port.costs, ref.costs)
        for batch in (0, 1, n - 1, n, 7, 32, 100):
            b = port.bounds(batch)
            np.testing.assert_array_equal(b, ref.bounds(batch))
            assert b[0] == 0 and b[-1] == batch and (np.diff(b) >= 0).all()
            if batch >= n and port.observed:
                assert (np.diff(b) >= 1).all()


def test_replica_router_validation_equals_jax():
    for mod in (placement, jplacement):
        with pytest.raises(ValueError):
            mod.ReplicaRouter(1)
        with pytest.raises(ValueError, match="min_frac"):
            mod.ReplicaRouter(2, min_frac=-0.1)
        with pytest.raises(ValueError):
            mod.ReplicaRouter(2).observe(np.ones(3))
        assert not mod.ReplicaRouter(2).observe(np.full(2, np.nan))
    assert placement.DEFAULT_MIGRATION_THRESHOLD \
        == jplacement.DEFAULT_MIGRATION_THRESHOLD


@pytest.mark.parametrize("batch", [0, 1, 5, 7, 16, 33])
def test_chunk_bounds_equals_jax(batch):
    for n in (1, 2, 3, 5):
        got = [sharded._chunk_bounds(batch, n, k) for k in range(n)]
        assert got == [jsharded._chunk_bounds(batch, n, k)
                       for k in range(n)]
        want = np.array_split(np.arange(batch), n)
        assert [hi - lo for lo, hi in got] == [len(w) for w in want]


def test_merge_shard_stats_equals_jax():
    """Sum keys, max keys (gauges and lockstep counters), rates from the
    summed counters, the degraded L2 delta from the summed squares, and
    `per_shard` riding along."""
    rng = np.random.default_rng(0)
    per_shard = []
    for s in range(3):
        hot, warm, cold = (int(x) for x in rng.integers(0, 100, 3))
        st = {"total_accesses": hot + warm + cold, "hot_hits": hot,
              "warm_hits": warm, "cold_misses": cold,
              "queue_depth": int(rng.integers(0, 4)),
              "max_queue_depth": int(rng.integers(0, 6)),
              "refreshes": s, "degraded_lookups": s,
              "degraded_rows": 3 * s, "degraded_l2_sq": float(s) * 1.5,
              "prefetch_hits": s, "prefetch_misses": 2,
              "off_critical_rows": s, "consume_ready": s,
              "consume_waited": 1}
        if s == 1:
            del st["consume_ready"]
        per_shard.append(st)
    got = sharded.merge_shard_stats(per_shard)
    assert got == jsharded.merge_shard_stats(per_shard)
    assert got["queue_depth"] == max(s["queue_depth"] for s in per_shard)
    assert got["hot_hits"] + got["warm_hits"] + got["cold_misses"] \
        == got["total_accesses"]
    assert sharded.merge_shard_stats([]) == jsharded.merge_shard_stats([])
