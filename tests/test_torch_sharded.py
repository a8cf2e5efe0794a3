"""The port's `sharded` backend: the law that it equals the port's `device`
path bit for bit under every placement, and its output, merged stats,
routing and migrations against the JAX package's sharded backend on the
same tables, traces and batches.

Everything runs on CPU tensors, so every unit takes the plain versions
(`fused_warm_lookup_tables`, `_pool_rows_core`'s reduction). Pooled floats
are held to the JAX backend within the summation bound
`2·eps·Σ|w·x|` per element (`ref.summation_bound`); integer counters,
placements, plans and routing splits are exact. Weighted means are held to
the port's own `device` path only (the JAX tiered path divides them by L,
ROADMAP.md Queue 3).

Mirrors the sharded cases of tests/test_storage.py, tests/test_placement.py
and tests/test_migration.py, and tests/test_online_update.py's update
during an in-flight migration.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingBagCollection as JEBC
from repro.core import EmbeddingStageConfig as JStage
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro.ps import AutoTuneConfig as JAutoTune
from repro.ps import PSConfig as JPSConfig
from repro.serving import BatcherConfig as JBatcherConfig
from repro.serving import ServingSession as JSession
from repro.storage import ShardPlacement as JPlacement
from repro_torch import storage
from repro_torch.convert import load_reference_params
from repro_torch.core.access_patterns import make_pattern
from repro_torch.core.embedding import (EmbeddingBagCollection,
                                        EmbeddingStageConfig)
from repro_torch.kernels.embedding_bag import fused, kernel, ref
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import AutoTuneConfig, PSConfig
from repro_torch.serving import BatcherConfig, ServingSession
from repro_torch.storage import ShardPlacement

ROWS, TABLES, DIM, POOL = 256, 6, 16, 6
# heavy tables stacked at one end: the contiguous split starts lopsided
SKEWED = ("one_item", "one_item", "high_hot", "med_hot", "random", "random")
TOL = dict(rtol=1e-4, atol=1e-5)
MLP = dict(bottom_mlp=(32, DIM), top_mlp=(16, 1))
# the integer counters of a merged report (rates are checked beside them)
INT_KEYS = ("total_accesses", "hot_hits", "warm_hits", "cold_misses",
            "evictions", "insertions", "warm_occupancy",
            "cold_gathered_rows", "staged_rows", "prefetch_hits",
            "prefetch_misses", "off_critical_rows", "degraded_rows",
            "degraded_lookups", "refreshes", "max_queue_depth",
            "queue_depth", "num_shards")
RATE_KEYS = ("hot_hit_rate", "warm_hit_rate", "cold_miss_rate",
             "cache_hit_rate", "off_critical_frac")


def _pats(hotness=SKEWED):
    return [make_pattern(h, ROWS, seed=t) for t, h in enumerate(hotness)]


PATS = _pats()


def _batch(batch, seed, pats=PATS):
    return np.stack([p.sample(batch, POOL, seed=seed * 100 + t)
                     for t, p in enumerate(pats)], axis=1).astype(np.int32)


def _trace(batches=3, batch=8, seed0=50):
    return np.concatenate([_batch(batch, seed0 + s)
                           for s in range(batches)], axis=0)


@pytest.fixture(scope="module")
def tables():
    """The JAX init's tables, shared by every backend of both packages."""
    jebc = JEBC(JStage(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
                       backend="xla"))
    return np.array(jebc.init(jax.random.PRNGKey(0))["tables"])


def _stage(name, combine="sum", **kw):
    return EmbeddingStageConfig(num_tables=TABLES, rows=ROWS, dim=DIM,
                                pooling=POOL, combine=combine, storage=name,
                                **kw)


def _ebc(tables, name="sharded", combine="sum"):
    return EmbeddingBagCollection(_stage(name, combine), device="cpu",
                                  tables=torch.from_numpy(tables.copy()))


def _jebc(name="sharded", combine="sum"):
    return JEBC(JStage(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
                       combine=combine, backend="xla", storage=name))


def _ps(fused_on=True, **kw):
    base = dict(hot_rows=16, warm_slots=16, window_batches=8,
                async_prefetch=True, fused_lookup=fused_on,
                warm_backing="device" if fused_on else "host")
    base.update(kw)
    return base


def _placement(kind, loads):
    loads = tuple(float(x) for x in loads)
    if kind == "scrambled":
        return dict(num_tables=TABLES, num_shards=3,
                    replicas=((2,), (0,), (2,), (1,), (0,), (1,)),
                    loads=loads, strategy="scrambled")
    return dict(num_tables=TABLES, num_shards=3,
                replicas=((0,), (1,), (2,), (0,), (0, 1, 2), (1, 2)),
                loads=loads, strategy="replicated")


def _build_kw(kind, package="port"):
    """build() arguments for a placement kind, in either package."""
    if kind in ("contiguous", "balanced"):
        return dict(num_shards=3 if kind == "contiguous" else 2,
                    placement=kind)
    loads = np.ones(TABLES)
    cls = ShardPlacement if package == "port" else JPlacement
    return dict(placement=cls(**_placement(kind, loads)))


def _pair(tables, kind, combine="sum", fused_on=True, parallel=True,
          **build):
    """(port device, port sharded, jax sharded ebc, jax params), built
    with the same config, trace and placement."""
    dev = _ebc(tables, "device", combine)
    sh = _ebc(tables, "sharded", combine)
    sh.storage.build(PSConfig(**_ps(fused_on)), trace=_trace(),
                     parallel=parallel, **_build_kw(kind), **build)
    jebc = _jebc("sharded", combine)
    params = {"tables": jnp.asarray(tables)}
    jebc.storage.build(params, JPSConfig(**_ps(fused_on)), trace=_trace(),
                       parallel=parallel, **_build_kw(kind, "jax"), **build)
    return dev, sh, jebc, params


def _dev(dev, idx, w=None):
    with torch.no_grad():
        return dev(torch.from_numpy(idx),
                   None if w is None else torch.from_numpy(w)).numpy()


def _assert_within(port, want, tables, idx, combine):
    bound = torch.stack([ref.summation_bound(
        torch.from_numpy(tables[t]), torch.from_numpy(idx[:, t]), None,
        combine) for t in range(TABLES)], 1).numpy()
    assert (np.abs(port - np.asarray(want)) <= bound).all()


def _same_stats(port, want):
    for k in INT_KEYS:
        assert port.get(k) == want.get(k), k
    for k in RATE_KEYS:
        assert port[k] == pytest.approx(want[k], abs=1e-12), k
    assert port["hot_hits"] + port["warm_hits"] + port["cold_misses"] \
        == port["total_accesses"]
    assert len(port["per_shard"]) == len(want["per_shard"])
    for p, w in zip(port["per_shard"], want["per_shard"]):
        for k in ("total_accesses", "hot_hits", "warm_hits",
                  "cold_misses", "evictions", "staged_rows"):
            assert p.get(k) == w.get(k), k


# ---------------------------------------------------------------------------
# registry, capabilities, lifecycle
# ---------------------------------------------------------------------------

def test_registry_capabilities_and_lifecycle(tables):
    assert storage.resolve("sharded") is storage.ShardedStorage
    ebc = _ebc(tables)
    st = ebc.storage
    assert ebc.tables.device.type == "cpu"
    caps = st.capabilities()
    assert caps.shardable and not (caps.migratable or caps.tunable
                                   or caps.stageable or caps.updatable)
    with pytest.raises(RuntimeError, match="build"):
        st.lookup(_batch(2, 0))
    st.build(PSConfig(**_ps()), trace=_trace(), num_shards=2)
    caps = st.capabilities()
    assert caps.describe() == ("stageable+async_prefetch+refreshable+"
                               "shardable+tunable+migratable+degradable+"
                               "fused_lookup+updatable")
    assert st.num_shards == 2 and len(st.shards) == 2
    assert st.table_slices == [slice(0, 3), slice(3, 6)]
    # the authoritative copy IS the collection's host tensor; units copy
    assert st._tables.__array_interface__["data"][0] \
        == ebc.tables.data_ptr()
    assert not np.shares_memory(st._units[0].ps.cold.tables, st._tables)
    st.close()
    st.close()
    assert not st.capabilities().tunable and st.stats()["num_shards"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        st.lookup(_batch(2, 0))
    st.build(PSConfig(**_ps()), trace=_trace(), num_shards=3)   # re-opens
    assert st.capabilities().migratable and st.num_shards == 3
    st.close()
    with pytest.raises(ValueError, match="pinned_rows"):
        EmbeddingBagCollection(_stage("sharded", pinned_rows=4),
                               device="cpu")
    with pytest.raises(ValueError, match="num_shards"):
        _ebc(tables).storage.build(PSConfig(**_ps()), num_shards=0)
    with pytest.raises(ValueError, match="trace="):
        _ebc(tables).storage.build(PSConfig(**_ps()), placement="balanced")


# ---------------------------------------------------------------------------
# the law: sharded == device, bit for bit, under any placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["contiguous", "balanced", "scrambled",
                                  "replicated"])
@pytest.mark.parametrize("fused_on", [True, False])
@pytest.mark.parametrize("parallel", [True, False])
def test_sharded_equals_device_bit_for_bit(tables, kind, fused_on,
                                           parallel):
    """Full and partial batches (a valid-hint), staged batches, a refresh
    and a committed update, serial and parallel fan-out."""
    dev = _ebc(tables, "device")
    sh = _ebc(tables)
    st = sh.storage
    st.build(PSConfig(**_ps(fused_on)), trace=_trace(), parallel=parallel,
             **_build_kw(kind))
    assert st.capabilities().fused_lookup == fused_on
    assert (st._pool is not None) == (parallel and st.num_shards > 1)
    for seed in range(5):
        idx = _batch(8 if seed != 3 else 5, seed)
        if seed < 4:
            st.stage(_batch(8, seed + 1))
        if seed == 2:
            st.hint_valid(3)                      # 5 padding queries
        np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    assert st.refresh()["refreshes"] >= 1
    rows = np.unique(_batch(8, 7)[:, 4].ravel())[:5]
    vals = np.random.default_rng(1).normal(size=(rows.size, DIM)).astype(
        np.float32)
    for s in (dev.storage, st):
        assert s.begin_update(1)
        s.apply_update(4, rows, vals)
        assert s.commit_update(1)["updated"]
    idx = _batch(8, 7)
    np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    stats = st.stats()
    assert stats["hot_hits"] + stats["warm_hits"] + stats["cold_misses"] \
        == stats["total_accesses"]
    st.close()


@pytest.mark.parametrize("combine,weighted", [("sum", True),
                                              ("mean", False),
                                              ("mean", True)])
@pytest.mark.parametrize("fused_on", [True, False])
def test_weighted_and_mean_pooling_equal_device(tables, combine, weighted,
                                                fused_on):
    dev = _ebc(tables, "device", combine)
    sh = _ebc(tables, "sharded", combine)
    sh.storage.build(PSConfig(**_ps(fused_on)), trace=_trace(),
                     **_build_kw("replicated"))
    rng = np.random.default_rng(4)
    for seed in range(3):
        idx = _batch(7, seed)
        w = rng.random(idx.shape).astype(np.float32) if weighted else None
        np.testing.assert_array_equal(sh(idx, w).numpy(), _dev(dev, idx, w))
    sh.storage.close()


# ---------------------------------------------------------------------------
# against the JAX sharded backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["contiguous", "balanced", "replicated"])
@pytest.mark.parametrize("fused_on", [True, False])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_sharded_matches_jax_sharded(tables, kind, fused_on, combine):
    """The same placement and units, the same pooled output within the
    summation bound, and the same merged stats (and per-shard ones), over
    staged, padded and refreshed batches."""
    dev, sh, jebc, params = _pair(tables, kind, combine, fused_on)
    st, jst = sh.storage, jebc.storage
    assert st.placement.replicas == jst.placement.replicas
    assert [list(u.table_ids) for u in st._units] \
        == [list(u.table_ids) for u in jst._units]
    assert [u.chunk for u in st._units] == [u.chunk for u in jst._units]
    for seed in range(4):
        idx = _batch(8, seed)
        for s in (st, jst):
            s.stage(_batch(8, seed + 1))
            if seed == 2:
                s.hint_valid(5)
        got = sh(idx).numpy()
        want = np.asarray(jebc.apply(params, jnp.asarray(idx)))
        _assert_within(got, want, tables, idx, combine)
        np.testing.assert_array_equal(got, _dev(dev, idx))
        if seed == 1:
            assert st.refresh()["refreshes"] == jst.refresh()["refreshes"]
    _same_stats(st.stats(), jst.stats())
    st.close()
    jst.close()


def test_degraded_mode_matches_jax_and_survives_migration(tables):
    dev, sh, jebc, params = _pair(tables, "contiguous",
                                  migration_threshold=1.1)
    st, jst = sh.storage, jebc.storage
    for seed in range(4):                        # warm, fill the window
        idx = _batch(8, seed)
        sh(idx)
        jebc.apply(params, jnp.asarray(idx))
    for s in (st, jst):
        assert s.set_degraded(True) and s.degraded()
    idx = _batch(8, 9)
    got = sh(idx).numpy()
    _assert_within(got, np.asarray(jebc.apply(params, jnp.asarray(idx))),
                   tables, idx, "sum")
    a, b = st.stats(), jst.stats()
    _same_stats(a, b)
    assert a["degraded_rows"] > 0
    assert a["degraded_l2_delta"] == pytest.approx(b["degraded_l2_delta"],
                                                   rel=1e-5)
    # the mode survives a migration swap: fresh units come up degraded
    plan = st.plan_migration()
    assert st.install_migration(plan)["migrated"]
    assert st.degraded() and all(ps.degraded() for ps in st.shards)
    st.set_degraded(False)
    assert not any(ps.degraded() for ps in st.shards)
    np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    st.close()
    jst.close()


# ---------------------------------------------------------------------------
# replica routing
# ---------------------------------------------------------------------------

def test_routing_matches_jax_and_stays_exact(tables):
    """The same observed replica costs give the same published splits in
    both packages; a moved split flushes exactly the moved table's staged
    batches, and lookups stay bit-exact as the slices move."""
    dev, sh, jebc, params = _pair(tables, "replicated")
    st, jst = sh.storage, jebc.storage
    assert st.update_routing() == jst.update_routing() == {
        "changed": False, "fractions": {4: [0.3333] * 3, 5: [0.5, 0.5]}}
    rng = np.random.default_rng(5)
    for step in range(6):
        idx = _batch(16, 20 + step)
        for s in (st, jst):
            s.stage(_batch(16, 21 + step))
        np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
        jebc.apply(params, jnp.asarray(idx))
        # the same synthetic service costs on both packages' replica
        # units: replica k of table t pays (1 + 3k) time units a row
        cost = rng.uniform(0.5, 1.5)
        for units in (st._units, jst._units):
            for u in units:
                if u.chunk is not None:
                    u.service_s = cost * (1 + 3 * u.chunk[0])
                    u.served_rows = 1
        got, want = st.update_routing(), jst.update_routing()
        assert got == want
    assert got["fractions"][4][0] > got["fractions"][4][2]
    bounds = st._routers[4].bounds(16)
    np.testing.assert_array_equal(bounds, jst._routers[4].bounds(16))
    assert list(bounds) != [0, 6, 11, 16]         # moved off equal slices
    idx = _batch(16, 40)
    np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    b5 = st._routers[5].bounds(16)
    assert [u.served_rows for u in st._units if u.chunk] \
        == [b - a for a, b in zip(bounds, bounds[1:])] \
        + [b - a for a, b in zip(b5, b5[1:])]
    st.close()
    jst.close()
    assert _ebc(tables).storage.update_routing() is None


# ---------------------------------------------------------------------------
# live migration
# ---------------------------------------------------------------------------

def test_migration_mid_stream_matches_jax(tables):
    """plan_migration on the live window gives the JAX plan; the swap is
    build-before-teardown; lookups equal `device` before, during and
    after it, and the JAX backend within the bound."""
    dev, sh, jebc, params = _pair(tables, "contiguous",
                                  migration_threshold=1.1)
    st, jst = sh.storage, jebc.storage
    st_pc = _ebc(tables)
    st_pc.storage.build(PSConfig(**_ps()), trace=_trace(), num_shards=3,
                        placement="contiguous", migration_threshold=1.1)

    def check(seed):
        idx = _batch(8, seed)
        got = sh(idx).numpy()
        np.testing.assert_array_equal(got, _dev(dev, idx))
        _assert_within(got, np.asarray(jebc.apply(params, jnp.asarray(idx))),
                       tables, idx, "sum")
        st_pc(idx)

    for seed in range(4):                        # before: fills the window
        for s in (st, jst, st_pc.storage):
            s.stage(_batch(8, seed + 1))
        check(seed)
    old_units = list(st.shards)
    plan, jplan = st.plan_migration(), jst.plan_migration()
    assert plan is not None and jplan is not None
    mig, jmig = plan["migration"], jplan["migration"]
    assert mig.moved_tables == jmig.moved_tables
    assert mig.new.replicas == jmig.new.replicas
    assert mig.imbalance_before == jmig.imbalance_before
    assert [p.perm.tolist() for p in plan["hot_plans"].values()] \
        == [p.perm.tolist() for p in jplan["hot_plans"].values()]
    check(4)                                     # during: plan in hand
    res, jres = st.install_migration(plan), jst.install_migration(jplan)
    assert res == jres and res["migrated"]
    assert st.placement.strategy == "balanced"
    assert all(ps.prefetch.closed for ps in old_units)   # orphans joined
    for seed in range(5, 9):                     # after the swap
        for s in (st, jst):
            s.stage(_batch(8, seed + 1))
        check(seed)
    _same_stats(st.stats(), jst.stats())
    # a stale plan installs as a no-op
    assert st.install_migration(plan) == {"migrated": False,
                                          "stale_plan": True}
    assert st.install_migration(None) == {"migrated": False}
    # the refresh path carries the same plan when a threshold is armed
    pc = st_pc.storage
    rplan = pc.plan_refresh()
    assert rplan["migration"] is not None
    rres = pc.install_refresh(rplan)
    assert rres["replanned"] and rres["migrated"]
    assert pc.placement.strategy == "balanced"
    idx = _batch(8, 30)
    np.testing.assert_array_equal(st_pc(idx).numpy(), _dev(dev, idx))
    for s in (st, jst, pc):
        s.close()


def _flaky(monkeypatch, fail_after):
    """ParameterServer constructions fail after `fail_after` successes."""
    import repro_torch.ps as ps_pkg
    real = ps_pkg.ParameterServer
    count = {"n": 0}

    class Flaky(real):
        def __init__(self, *a, **kw):
            if count["n"] >= fail_after:
                raise MemoryError("synthetic constructor failure")
            count["n"] += 1
            super().__init__(*a, **kw)

    monkeypatch.setattr(ps_pkg, "ParameterServer", Flaky)


@pytest.mark.parametrize("what", ["migration", "rebuild"])
def test_failed_migration_or_rebuild_leaves_old_units_serving(
        tables, monkeypatch, what):
    dev = _ebc(tables, "device")
    sh = _ebc(tables)
    st = sh.storage
    st.build(PSConfig(**_ps()), trace=_trace(), num_shards=2,
             placement="contiguous", migration_threshold=1.1)
    for seed in range(4):
        sh(_batch(8, seed))
    plan = st.plan_migration()
    assert plan is not None
    old_placement, old_units = st.placement, list(st.shards)
    _flaky(monkeypatch, fail_after=1)            # the second unit fails
    with pytest.raises(MemoryError):
        if what == "migration":
            st.install_migration(plan)
        else:
            st.build(PSConfig(**_ps()), trace=_trace(), num_shards=3)
    assert st.placement is old_placement and st.shards == old_units
    caps = st.capabilities()
    assert caps.stageable and caps.async_prefetch    # old workers alive
    idx = _batch(8, 9)
    np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    monkeypatch.undo()
    assert st.install_migration(plan)["migrated"]
    np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    st.close()


def test_update_during_inflight_migration(tables):
    """A delta lands while a migration plan is in hand: it commits, and
    installing the (pre-update) plan afterwards carries the new bytes —
    the new units are built from the updated authoritative copy."""
    dev = _ebc(tables, "device")
    sh = _ebc(tables)
    st = sh.storage
    st.build(PSConfig(**_ps()), trace=_trace(), num_shards=2,
             placement="contiguous", migration_threshold=1.1)
    for seed in range(4):
        st.stage(_batch(8, seed + 1))
        sh(_batch(8, seed))
    plan = st.plan_migration()
    assert plan is not None
    rng = np.random.default_rng(2)
    for s in (dev.storage, st):
        s.begin_update(1)
    for t in (0, 4):
        rows = rng.choice(ROWS, size=12, replace=False)
        vals = rng.normal(size=(12, DIM)).astype(np.float32)
        for s in (dev.storage, st):
            s.apply_update(t, rows, vals)
    assert dev.storage.commit_update(1)["updated"]
    res = st.commit_update(1)
    assert res["updated"] and res["units"] >= 1 and st.version() == 1
    idx = _batch(8, 9)
    np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    assert st.install_migration(plan)["migrated"]
    assert st.version() == 1                     # migration keeps the epoch
    np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    # an abort leaves the committed version serving
    assert st.begin_update(2)
    st.apply_update(1, np.array([0]), np.ones((1, DIM), np.float32))
    assert st.abort_update(2) and st.version() == 1
    np.testing.assert_array_equal(sh(idx).numpy(), _dev(dev, idx))
    st.close()


# ---------------------------------------------------------------------------
# the launch counters under the shard threads
# ---------------------------------------------------------------------------

def test_launch_counters_exact_under_parallel_fanout(tables, monkeypatch):
    """Each unit launches the fused kernel once a forward, from its shard
    thread; the counters must add up exactly. On the CPU the units take
    the plain branch, so it is made to count (and to yield, so the shard
    threads interleave) the way the kernel wrapper counts."""
    plain = fused.fused_warm_lookup_tables

    def counting(*a, **kw):
        fused._count_launch()
        time.sleep(0.001)
        return plain(*a, **kw)

    monkeypatch.setattr(fused, "fused_warm_lookup_tables", counting)
    sh = _ebc(tables)
    sh.storage.build(PSConfig(**_ps()), trace=_trace(),
                     **_build_kw("replicated"))
    units = len(sh.storage._units)
    assert units == 8 and sh.storage._pool is not None
    before = fused.LAUNCHES, kernel.LAUNCHES
    for seed in range(10):
        sh(_batch(8, seed))
    assert fused.LAUNCHES - before[0] == 10 * units
    assert kernel.LAUNCHES == before[1]           # the CPU launches nothing
    sh.storage.close()

    # the counter itself, hammered from 8 threads
    start = fused.LAUNCHES, kernel.LAUNCHES
    barrier = threading.Barrier(8)

    def hammer():
        barrier.wait()
        for _ in range(20_000):
            fused._count_launch()
            kernel._count_launch()
    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (fused.LAUNCHES - start[0], kernel.LAUNCHES - start[1]) \
        == (160_000, 160_000)


# ---------------------------------------------------------------------------
# serving: the session and the auto-tuner's placement legs
# ---------------------------------------------------------------------------

def _models(kind, **build):
    """A JAX sharded DLRM and the port's on its converted params."""
    jmodel = JDLRM(JConfig(embedding=JStage(
        num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL, backend="xla",
        storage="sharded"), **MLP))
    params = jmodel.init(jax.random.PRNGKey(1))
    jmodel.ebc.storage.build(params, JPSConfig(**_ps()), trace=_trace(),
                             **_build_kw(kind, "jax"), **build)
    model = DLRM(DLRMConfig(embedding=_stage("sharded"), **MLP),
                 device="cpu")
    load_reference_params(model, jax.tree_util.tree_map(np.asarray, params))
    model.ebc.storage.build(PSConfig(**_ps()), trace=_trace(),
                            **_build_kw(kind), **build)
    return jmodel, params, model


def _tap(sess):
    got = {}
    sess.server.on_batch = lambda batch, scores: got.update(
        {q.qid: float(s) for q, s in zip(batch, scores)})
    return got


def _slow_replica(units, method):
    """Replica 1 of table 4 pays 3 ms a routed row on its lookups (a
    contended shard), as the reference's sharded_migration bench does."""
    for u in units:
        if u.chunk is not None and u.chunk[0] == 1 and u.table_ids[0] == 4:
            real = getattr(u.ps, method)

            def slow(idx, *a, real=real, **kw):
                time.sleep(idx.shape[0] * 3e-3)
                return real(idx, *a, **kw)
            setattr(u.ps, method, slow)


@pytest.mark.parametrize("kind,tune", [
    ("contiguous", dict(migrate_every_batches=3, migrate_threshold=1.1)),
    ("replicated", dict(route_every_batches=2))])
def test_session_and_auto_tuner_match_jax(kind, tune):
    """ServingSession over `sharded` on both packages, with the
    auto-tuner's migration or routing leg on: the same scores within the
    tolerance. Migration: the same events (batches and imbalances) and
    cache counters. Routing (split by measured seconds, so each package
    follows its own timings): a slow replica loses share in both."""
    jmodel, params, model = _models(kind)
    assert model.ebc.storage.capabilities().migratable
    routing = "route_every_batches" in tune
    if routing:
        _slow_replica(model.ebc.storage._units, "lookup_fused")
        _slow_replica(jmodel.ebc.storage._units, "lookup_fused")
    cfg = dict(max_batch=8, max_wait_s=0.0)
    dense = np.random.default_rng(3).normal(size=(64, 13)).astype(
        np.float32)
    idx = _trace(batches=8, seed0=10)
    with JSession(jmodel, params, batcher=JBatcherConfig(**cfg),
                  sla_ms=1e6,
                  auto_tune=JAutoTune(depth_every_batches=0, **tune)) as js, \
            ServingSession(model, batcher=BatcherConfig(**cfg), sla_ms=1e6,
                           auto_tune=AutoTuneConfig(
                               depth_every_batches=0, **tune)) as ps_:
        want, got = _tap(js), _tap(ps_)
        for sess in (js, ps_):
            for b in range(8):
                sess.submit_batch(dense[b * 8:(b + 1) * 8],
                                  idx[b * 8:(b + 1) * 8])
                if b >= 1:
                    sess.poll()
            sess.drain()
        assert sorted(got) == sorted(want) == list(range(64))
        torch.testing.assert_close(torch.tensor([got[q] for q in range(64)]),
                                   torch.tensor([want[q] for q in range(64)]),
                                   **TOL)
        jp, pp = js.percentiles(), ps_.percentiles()
        assert pp["served"] == jp["served"] == 64
        if routing:
            for sess in (js, ps_):
                assert sess.tuner.events and sess.tuner.events[0][
                    "kind"] == "routing"
                assert sess.storage._routers[4].fractions()[1] < 1 / 3
            return
        kinds = [(e["kind"], e["batch"], e["imbalance_after"])
                 for e in ps_.tuner.events]
        assert kinds == [(e["kind"], e["batch"], e["imbalance_after"])
                         for e in js.tuner.events]
        assert kinds and pp["migrations"] == len(kinds)
        assert model.ebc.storage.placement.strategy == "balanced"
        for k in ("hot_hits", "warm_hits", "cold_misses"):
            assert pp[k] == jp[k], k
