"""The port's `pool` backend (worker processes over one shared host cold
tier), on the CPU.

Mirrors the backend cases of tests/test_pool.py, and
tests/test_online_update.py's pool commit rollback. Every
worker's units run on CPU tensors, so they take the plain versions.

  * The law: `pool` equals the port's `device` backend bit for bit, on
    every placement (contiguous, balanced, replicated), fused and unfused,
    weighted mean, staged batches, a refresh, a live rebuild, a worker
    respawn, a migration (rolled back, then applied), degraded mode (equal
    to the port's `sharded` backend), updates, and tenants.
  * Against the JAX package's dense XLA route on the same tables: within
    the north star's summation bound `2·eps·Σ|w·x|` per element
    (`ref.summation_bound`), sum and unweighted mean.
  * The merged stats follow the sharded merge law, and their keys are the
    JAX package's `sharded` report's (threads only: no JAX pool is spawned
    here), plus the pool's own `pool` accounting.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingBagCollection as JEBC
from repro.core import EmbeddingStageConfig as JStage
from repro.ps import PSConfig as JPSConfig
from repro_torch import storage
from repro_torch.core.access_patterns import make_pattern
from repro_torch.core.embedding import (EmbeddingBagCollection,
                                        EmbeddingStageConfig)
from repro_torch.kernels.embedding_bag import ref
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import AutoTuneConfig, PSConfig
from repro_torch.serving import BatcherConfig, ServingSession
from repro_torch.storage import (PoolStorage, ShardPlacement,
                                 TenantStorage, WorkerDeadError)
from repro_torch.storage.pool.transport import attach_segment

ROWS, TABLES, DIM, POOL = 256, 6, 16, 6
# heavy tables stacked at one end => the contiguous split starts lopsided
SKEWED = ("one_item", "one_item", "high_hot", "med_hot", "random", "random")
PATS = [make_pattern(h, ROWS, seed=t) for t, h in enumerate(SKEWED)]


def _batch(batch, seed):
    return np.stack([p.sample(batch, POOL, seed=seed * 100 + t)
                     for t, p in enumerate(PATS)], axis=1).astype(np.int32)


def _trace(batches=3, batch=8, seed0=50):
    return np.concatenate([_batch(batch, seed0 + s)
                           for s in range(batches)], axis=0)


@pytest.fixture(scope="module")
def tables():
    """The JAX init's tables, shared by every backend of both packages."""
    jebc = JEBC(JStage(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
                       backend="xla"))
    return np.array(jebc.init(jax.random.PRNGKey(0))["tables"])


def _stage(name, combine="sum", num_tables=TABLES, pooling=POOL):
    return EmbeddingStageConfig(num_tables=num_tables, rows=ROWS, dim=DIM,
                                pooling=pooling, combine=combine,
                                storage=name)


def _ebc(tables, name="pool", combine="sum"):
    return EmbeddingBagCollection(_stage(name, combine), device="cpu",
                                  tables=torch.from_numpy(tables.copy()))


def _ps(**kw):
    base = dict(hot_rows=16, warm_slots=16, async_prefetch=True,
                window_batches=8)
    base.update(kw)
    return PSConfig(**base)


def _build_pool(tables, ps_cfg=None, combine="sum", **kw):
    ebc = _ebc(tables, "pool", combine)
    kw.setdefault("num_workers", 2)
    ebc.storage.build(ps_cfg or _ps(), trace=_trace(), **kw)
    return ebc


def _lookup(ebc, idx, w=None):
    with torch.no_grad():
        return ebc(idx, w).numpy()


def _dev(tables, idx, w=None, combine="sum"):
    """The port's `device` backend on the same tables."""
    dev = _ebc(tables, "device", combine)
    with torch.no_grad():
        return dev(torch.from_numpy(idx),
                   None if w is None else torch.from_numpy(w)).numpy()


def _jax_dense(tables, idx, combine="sum"):
    """The JAX package's dense XLA route on the same tables."""
    jebc = JEBC(JStage(num_tables=tables.shape[0], rows=ROWS, dim=DIM,
                       pooling=idx.shape[2], combine=combine, backend="xla"))
    return np.asarray(jebc.apply({"tables": jnp.asarray(tables)},
                                 jnp.asarray(idx)))


def _check(ebc, tables, seed, batch=8, combine="sum"):
    """pool == device bit for bit; within the bound of the JAX route."""
    idx = _batch(batch, seed)
    got = _lookup(ebc, idx)
    np.testing.assert_array_equal(got, _dev(tables, idx, combine=combine))
    bound = torch.stack([ref.summation_bound(
        torch.from_numpy(tables[t]), torch.from_numpy(idx[:, t]), None,
        combine) for t in range(tables.shape[0])], 1).numpy()
    assert (np.abs(got - _jax_dense(tables, idx, combine)) <= bound).all()


# ---------------------------------------------------------------------------
# the law on every placement path
# ---------------------------------------------------------------------------

def test_pool_bit_exact_and_rebuild(tables):
    """Contiguous placement, then a LIVE rebuild to balanced on the same
    backend — staging and refresh interleaved, every answer bit-exact."""
    ebc = _build_pool(tables, placement="contiguous")
    st = ebc.storage
    with st:
        assert storage.resolve("pool") is PoolStorage
        caps = st.capabilities()
        assert caps.stageable and caps.async_prefetch and caps.migratable
        assert st.num_shards == 2 and st.num_workers == 2
        for seed in range(4):
            if seed == 1:       # staged payloads must not change values
                st.stage(_batch(8, 2))
            if seed == 3:       # neither must a mid-stream re-pin
                assert st.refresh()["replanned"]
            _check(ebc, tables, seed)
        # live rebuild: balanced placement, old workers serve until the
        # new pool is fully constructed
        st.build(_ps(), trace=_trace(), num_workers=2, placement="balanced")
        assert st.placement.strategy == "balanced"
        for seed in range(4, 8):
            _check(ebc, tables, seed)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_pool_fused_bit_exact(tables, combine):
    ebc = _build_pool(tables, _ps(warm_backing="device", fused_lookup=True,
                                  async_prefetch=False), combine=combine)
    with ebc.storage:
        assert ebc.storage.capabilities().fused_lookup
        for seed in range(3):
            _check(ebc, tables, seed, combine=combine)


@pytest.mark.parametrize("fused_on", [False, True])
def test_pool_weighted_mean_bit_exact(tables, fused_on):
    """Weighted mean against the port's `device` path only (the JAX
    routes divide a weighted mean differently: ROADMAP.md Queue 3)."""
    ps = (_ps(warm_backing="device", fused_lookup=True) if fused_on
          else _ps())
    ebc = _build_pool(tables, ps, combine="mean")
    with ebc.storage:
        idx = _batch(8, 0)
        w = np.random.default_rng(3).random((8, TABLES, POOL)).astype(
            np.float32)
        np.testing.assert_array_equal(
            _lookup(ebc, idx, torch.from_numpy(w)),
            _dev(tables, idx, w, combine="mean"))


def test_pool_replicated_placement_routes_and_dedups(tables):
    """A replicated table served by two worker PROCESSES: routed slices
    still partition the batch bit-exactly, and the replica's cold rows
    cost zero extra resident bytes (both copies are views of the one
    shared host segment)."""
    plc = ShardPlacement(num_tables=TABLES, num_shards=2,
                         replicas=((0, 1), (0,), (0,), (1,), (1,), (0, 1)),
                         loads=tuple(1.0 for _ in range(TABLES)))
    ebc = _build_pool(tables, placement=plc)
    st = ebc.storage
    with st:
        for seed in range(4):
            _check(ebc, tables, seed, batch=9)  # odd batch
        routed = st.update_routing()
        assert set(routed["fractions"]) == {0, 5}
        for f in routed["fractions"].values():
            assert sum(f) == pytest.approx(1.0)
        for seed in range(4, 7):                # after a routing pass
            _check(ebc, tables, seed, batch=9)
        acct = st.stats()["pool"]
        nbytes = TABLES * ROWS * DIM * 4
        # one shared host copy; every unit here is a contiguous run (the
        # replicas are single tables), so nothing was privately copied
        assert acct["shared_host_bytes"] == nbytes
        assert acct["private_cold_bytes"] == 0
        assert acct["resident_cold_bytes"] == nbytes
        assert acct["host_view_bytes"] > nbytes


def test_pool_worker_crash_respawns_and_stays_bit_exact(tables):
    ebc = _build_pool(tables)
    st = ebc.storage
    with st:
        _check(ebc, tables, 0)
        st._transports[0].kill()                # SIGKILL mid-serving
        _check(ebc, tables, 1)                  # respawn + retry, exact
        status = st.worker_status()
        assert [w["alive"] for w in status] == [True, True]
        assert status[0]["units"] == [u.unit_id
                                      for u in st._worker_units[0]]
        # the port-only heartbeat fields: CPU units launch no kernel
        assert all(w["launches"] == {"bag": 0, "fused": 0} for w in status)
        assert st.take_worker_launches()["fused"] == 0
        s = st.stats()
        assert (s["hot_hits"] + s["warm_hits"] + s["cold_misses"]
                == s["total_accesses"])


# ---------------------------------------------------------------------------
# cross-process migration, rebuild and update: build before teardown
# ---------------------------------------------------------------------------

def test_pool_migration_rollback_then_success(tables):
    ebc = _build_pool(tables, placement="contiguous",
                      migration_threshold=1.1)
    st = ebc.storage
    with st:
        for seed in range(4):                   # before (fills the window)
            st.stage(_batch(8, seed + 1))
            _check(ebc, tables, seed)
        plan = st.plan_migration()
        assert plan is not None                 # skew crossed the threshold
        old_placement = st.placement

        # a worker killed mid-swap: phase 1 fails, pending units abort on
        # the survivor, the dead worker respawns with the OLD units
        st._transports[1].kill()
        res = st.install_migration(plan)
        assert res == {"migrated": False, "rolled_back": True,
                       "respawned_workers": [1]}
        assert st.placement is old_placement    # old pool still serving
        _check(ebc, tables, 4)

        # the same plan still matches the (unchanged) placement: apply it
        res = st.install_migration(plan)
        assert res["migrated"]
        assert res["imbalance_after"] < res["imbalance_before"]
        assert st.placement.strategy == "balanced"
        for seed in range(5, 9):                # after the swap
            st.stage(_batch(8, seed + 1))
            _check(ebc, tables, seed)
        # a raced plan (planned against the old placement) is a no-op
        assert st.install_migration(plan) == {"migrated": False,
                                              "stale_plan": True}
        s = st.stats()
        assert (s["hot_hits"] + s["warm_hits"] + s["cold_misses"]
                == s["total_accesses"])


def test_pool_rebuild_failure_leaves_old_pool_serving(tables):
    """A rebuild whose workers never come up (boot deadline exceeded)
    destroys only the NEW processes and segment — the old pool keeps
    serving bit-exactly."""
    ebc = _build_pool(tables)
    st = ebc.storage
    with st:
        _check(ebc, tables, 0)
        old_transports, old_meta = list(st._transports), st._seg_meta
        with pytest.raises(WorkerDeadError):
            st.build(_ps(hot_rows=8, warm_slots=8), trace=_trace(),
                     num_workers=2, rpc_timeout=0.01)  # boot takes ~1 s
        assert st._transports == old_transports
        assert st._seg_meta == old_meta
        assert st.capabilities().stageable
        assert st._timeout > 1.0                # old RPC deadline restored
        _check(ebc, tables, 1)


def test_pool_worker_kill_between_apply_and_commit_rolls_back(tables):
    """Mirrors tests/test_online_update.py's pool case: a worker killed
    between apply and commit rolls the update back (the old version keeps
    serving); the retry commits, the segment and the collection's tables
    take the rows, and a respawned worker serves them."""
    ebc = _build_pool(tables)
    st = ebc.storage
    rng = np.random.default_rng(3)
    changed = {int(t): (rng.choice(ROWS, 5, replace=False),
                        rng.normal(size=(5, DIM)).astype(np.float32))
               for t in (1, 4)}
    want = tables.copy()
    for t, (rows, vals) in changed.items():
        want[t, rows] = vals
    with st:
        _check(ebc, tables, 3)
        st.begin_update(1)
        for t, (rows, vals) in changed.items():
            st.apply_update(t, rows, vals)
        st._transports[0].kill()                 # dies between apply & commit
        res = st.commit_update(1)
        assert not res["updated"] and res["rolled_back"], res
        assert 0 in res["respawned_workers"], res
        assert st.version() == 0
        _check(ebc, tables, 3)
        st.begin_update(1)
        for t, (rows, vals) in changed.items():
            st.apply_update(t, rows, torch.from_numpy(vals))
        res = st.commit_update(1)
        assert res["updated"] and st.version() == 1, res
        _check(ebc, want, 3)
        np.testing.assert_array_equal(ebc.tables.numpy(), want)
        st._transports[1].kill()                 # rebuilt from the segment
        _check(ebc, want, 4)


# ---------------------------------------------------------------------------
# degraded mode across processes
# ---------------------------------------------------------------------------

def test_pool_degraded_matches_thread_sharded(tables):
    """Warm-cache-only serving is deterministic given cache state, and the
    pool evolves per-unit caches exactly as the thread-sharded backend
    does (same units, same batches) — so degraded answers must MATCH the
    sharded backend bit-for-bit, and the flag must survive a respawn."""
    ps = _ps(async_prefetch=False)
    ebc_s = _ebc(tables, "sharded")
    ebc_s.storage.build(ps, trace=_trace(), num_shards=2,
                        placement="contiguous")
    ebc_p = _build_pool(tables, ps, placement="contiguous")
    with ebc_s.storage, ebc_p.storage:
        for seed in range(2):                   # same warm-up traffic
            idx = _batch(8, seed)
            np.testing.assert_array_equal(_lookup(ebc_s, idx),
                                          _lookup(ebc_p, idx))
        assert ebc_s.storage.set_degraded(True)
        assert ebc_p.storage.set_degraded(True)
        assert ebc_p.storage.degraded()
        for seed in range(2, 5):
            idx = _batch(8, seed)
            np.testing.assert_array_equal(_lookup(ebc_s, idx),
                                          _lookup(ebc_p, idx))
        sp = ebc_p.storage.stats()
        assert sp["degraded_lookups"] >= 1 and sp["degraded_rows"] > 0
        # a respawned worker must come up in the PUBLISHED serving mode
        ebc_p.storage._transports[1].kill()
        _lookup(ebc_p, _batch(8, 9))
        assert all(w["degraded"] for w in ebc_p.storage.worker_status())
        # exact serving restores bit-exactness vs dense
        assert ebc_p.storage.set_degraded(False)
        _check(ebc_p, tables, 10)


# ---------------------------------------------------------------------------
# stats: the merge law is SHARED across backends, and with the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded_keys(tables):
    """The keys of the JAX package's merged `sharded` report after the
    same traffic (its thread backend: no JAX worker process)."""
    jebc = JEBC(JStage(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
                       backend="xla", storage="sharded"))
    jebc.storage.build({"tables": jnp.asarray(tables)},
                       JPSConfig(hot_rows=16, warm_slots=16,
                                 async_prefetch=True, window_batches=8),
                       trace=_trace(), num_shards=2)
    with jebc.storage:
        for seed in range(3):
            jebc.storage.stage(_batch(8, seed + 1))
            jebc.apply({}, jnp.asarray(_batch(8, seed)))
        st = jebc.storage.stats()
    return set(st), set(st["per_shard"][0])


@pytest.mark.parametrize("backend,build_kw", [
    ("sharded", {"num_shards": 2}),
    ("pool", {"num_workers": 2}),
])
def test_stats_merge_law_schema_across_backends(tables, jax_sharded_keys,
                                                backend, build_kw):
    """Both fan-out backends publish the same merged-report schema under
    the same law: counter keys are per-shard SUMS, rates recompute from
    the summed counters, and queue gauges (`queue_depth`,
    `max_queue_depth`) are per-shard MAXES — a queue is a per-shard
    resource, so summing gauges would fabricate depth. The keys are the
    JAX package's sharded report's (plus the pool's `pool` block)."""
    ebc = _ebc(tables, backend)
    ebc.storage.build(_ps(), trace=_trace(), **build_kw)
    with ebc.storage:
        for seed in range(3):
            ebc.storage.stage(_batch(8, seed + 1))
            _lookup(ebc, _batch(8, seed))
        st = ebc.storage.stats()
        top, shard = jax_sharded_keys
        assert set(st) - {"pool"} == top
        assert set(st["per_shard"][0]) == shard
        assert st["num_shards"] == 2 and len(st["per_shard"]) == 2
        assert st["total_accesses"] == 3 * 8 * TABLES * POOL
        assert (st["hot_hits"] + st["warm_hits"] + st["cold_misses"]
                == st["total_accesses"])
        assert 0.0 <= st["cache_hit_rate"] <= 1.0
        for key in ("total_accesses", "hot_hits", "warm_hits",
                    "cold_misses", "prefetch_hits", "staged_rows"):
            assert st[key] == sum(s[key] for s in st["per_shard"]), key
        for key in ("queue_depth", "max_queue_depth"):
            assert st[key] == max(s[key] for s in st["per_shard"]), key
        assert st["max_queue_depth"] >= 1       # staging actually queued
        if backend == "pool":
            assert st["pool"]["num_workers"] == 2
            assert st["pool"]["resident_cold_bytes"] \
                == st["pool"]["shared_host_bytes"] \
                + st["pool"]["private_cold_bytes"]
        ebc.storage.reset_stats()
        assert ebc.storage.stats()["total_accesses"] == 0


# ---------------------------------------------------------------------------
# lifecycle & serving-loop integration
# ---------------------------------------------------------------------------

def test_pool_lifecycle_validation(tables):
    ebc = _ebc(tables)
    assert isinstance(ebc.storage, PoolStorage)
    assert "pool" in storage.available()
    with pytest.raises(RuntimeError, match="build"):
        _lookup(ebc, _batch(4, 0))
    with pytest.raises(ValueError, match="num_workers"):
        ebc.storage.build(_ps(), num_workers=0)
    with pytest.raises(ValueError, match="num_shards"):
        ebc.storage.build(_ps(), num_workers=2, num_shards=0)
    with pytest.raises(ValueError, match="pinned_rows"):
        EmbeddingBagCollection(EmbeddingStageConfig(
            num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
            storage="pool", pinned_rows=4), device="cpu")


def test_pool_close_joins_workers_and_capabilities_drop(tables):
    ebc = _build_pool(tables)
    st = ebc.storage
    procs = [t.proc for t in st._transports]
    seg_name = st._segment.name
    assert st.capabilities().stageable
    st.close()
    assert all(not p.is_alive() for p in procs)
    caps = st.capabilities()
    assert not (caps.stageable or caps.tunable or caps.migratable)
    with pytest.raises(RuntimeError, match="closed"):
        _lookup(ebc, _batch(4, 0))
    with pytest.raises(FileNotFoundError):      # host memory reclaimed
        attach_segment(seg_name)
    st.close()                                  # idempotent


def test_pool_session_autotune_migrates(tables):
    """The serving loop — traffic, threshold crossing, live swap — driven
    end to end through worker processes by the auto-tuner."""
    model = DLRM(DLRMConfig(embedding=_stage("pool"), bottom_mlp=(32, DIM),
                            top_mlp=(16, 1)), device="cpu", seed=0)
    model.ebc.storage.build(_ps(), trace=_trace(), num_workers=2,
                            placement="contiguous")
    cfg = AutoTuneConfig(depth_every_batches=0, migrate_every_batches=3,
                         migrate_threshold=1.1)
    with ServingSession(model,
                        batcher=BatcherConfig(max_batch=8, max_wait_s=0.0),
                        sla_ms=1e6, auto_tune=cfg) as sess:
        for b in range(8):
            dense = np.zeros((8, model.cfg.dense_features), np.float32)
            sess.submit_batch(dense, _batch(8, b))
            if b >= 1:
                sess.poll()
        sess.drain()
        pct = sess.percentiles()
    migs = [e for e in sess.tuner.events if e["kind"] == "migration"]
    assert len(migs) >= 1
    assert pct["migrations"] == len(migs)
    assert model.ebc.storage.placement.strategy == "balanced"
    model.ebc.storage.close()


# ---------------------------------------------------------------------------
# tenancy over processes: static namespaces, merge law, respawn re-apply
# ---------------------------------------------------------------------------

def _pool_tenants(tables, **kw):
    ebc = _ebc(tables)
    kw.setdefault("num_workers", 2)
    kw.setdefault("tenants", {"a": 2, "b": 4})
    ebc.storage.build(_ps(hot_rows=32, async_prefetch=False), **kw)
    return ebc.storage


def _slice_ref(tables, idx):
    """The port's `device` backend over a tenant's slice of the tables."""
    dev = EmbeddingBagCollection(_stage("device", num_tables=tables.shape[0],
                                        pooling=idx.shape[2]),
                                 device="cpu",
                                 tables=torch.from_numpy(tables.copy()))
    with torch.no_grad():
        return dev(torch.from_numpy(idx)).numpy()


def test_pool_tenants_bit_exact_and_merge_law(tables):
    """Two tenants over one worker pool: per-tenant lookups bit-exact
    against the dense slice, whole-backend lookup undefined, tenant-axis
    stats merge law (counters and device bytes fold into the shared
    report), pool tenancy static (typed attach/detach errors)."""
    st = _pool_tenants(tables)
    try:
        rng = np.random.default_rng(0)
        ia = rng.integers(0, ROWS, size=(8, 2, POOL)).astype(np.int32)
        ib = rng.integers(0, ROWS, size=(8, 4, 3)).astype(np.int32)
        va, vb = TenantStorage(st, "a"), TenantStorage(st, "b")
        ra = _slice_ref(tables[0:2], ia)
        rb = _slice_ref(tables[2:6], ib)        # per-tenant pooling L
        np.testing.assert_array_equal(va.lookup(ia).numpy(), ra)
        np.testing.assert_array_equal(vb.lookup(ib).numpy(), rb)
        assert (np.abs(vb.lookup(ib).numpy() - _jax_dense(tables[2:6], ib))
                <= 2 * ref.F32_EPS * np.abs(tables[2:6][
                    np.arange(4)[None, :, None], ib]).sum(axis=2)).all()
        with pytest.raises(RuntimeError, match="tenancy"):
            st.lookup(np.zeros((1, TABLES, POOL), np.int32))
        st_all = st.stats()
        assert set(st_all) == {"tenants", "shared"}
        ta, tb, sh = (st_all["tenants"]["a"], st_all["tenants"]["b"],
                      st_all["shared"])
        for key in ("total_accesses", "hot_hits", "warm_hits",
                    "cold_misses", "device_bytes"):
            assert ta[key] + tb[key] == sh[key], key
        assert sh["num_tenants"] == 2 and "pool" in sh
        # per-tenant runtime knobs are isolated
        assert va.set_degraded(True) and va.degraded()
        assert not vb.degraded()
        va.set_degraded(False)
        assert va.set_prefetch_depth(3)
        assert va.prefetch_depth() == 3 != vb.prefetch_depth()
        # static tenancy: rebuild, don't mutate, the namespace layout
        with pytest.raises(RuntimeError, match="static"):
            st.attach_tenant("c", tables[:1])
        with pytest.raises(RuntimeError, match="static"):
            st.detach_tenant("a")
        # tenant-scoped retune, refresh and update keep answers exact
        assert va.retune_capacities(2 << 20)["tenant"] == "a"
        va.lookup(ia)
        va.refresh()
        np.testing.assert_array_equal(va.lookup(ia).numpy(), ra)
        vals = rng.normal(size=(3, DIM)).astype(np.float32)
        assert va.begin_update(1)
        va.apply_update(1, np.array([5, 6, 7]), vals)
        assert va.commit_update(1)["updated"]
        assert va.version() == 1 and vb.version() == 0
        want = tables[0:2].copy()
        want[1, [5, 6, 7]] = vals
        np.testing.assert_array_equal(va.lookup(ia).numpy(),
                                      _slice_ref(want, ia))
        np.testing.assert_array_equal(vb.lookup(ib).numpy(), rb)
    finally:
        st.close()


def test_pool_tenant_state_survives_worker_respawn(tables):
    """A killed worker respawns with its tenant units' depth/degraded
    state re-applied — per-tenant knobs are pool state, not process
    state."""
    st = _pool_tenants(tables)
    try:
        rng = np.random.default_rng(1)
        ia = rng.integers(0, ROWS, size=(8, 2, POOL)).astype(np.int32)
        va = TenantStorage(st, "a")
        ra = _slice_ref(tables[0:2], ia)
        assert va.set_prefetch_depth(3)
        st._transports[0].proc.kill()
        st._transports[0].proc.join()
        np.testing.assert_array_equal(va.lookup(ia).numpy(), ra)
        assert va.prefetch_depth() == 3
    finally:
        st.close()
