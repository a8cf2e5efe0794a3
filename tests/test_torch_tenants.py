"""The port's multi-tenant serving: `TenantManager`/`TenantSpec` over one
shared `sharded` backend (`storage/tenancy.py`'s `TenantStorage` views),
the budget arbiter, and `traffic.replay_tenants` — against the JAX
package's manager on the same params, traffic and schedule.

Everything runs on CPU tensors (the plain versions of the kernels). Each
tenant's logits equal its own `device` model's bit for bit inside the port,
and the JAX tenant's within `rtol=1e-4, atol=1e-5`; cache counters,
arbiter rounds and replay counts are exact. Replays run on a
`VirtualClock` with a modelled batch service time (the server's clock
patched in both packages), so their schedules are deterministic.

Mirrors tests/test_tenants.py.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import repro.serving.server as jserver
from repro.core import EmbeddingStageConfig as JStage
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro.ps import PSConfig as JPSConfig
from repro.ps.tuning import ArbiterConfig as JArbiter
from repro.serving import BatcherConfig as JBatcherConfig
from repro.serving import TenantManager as JManager
from repro.serving import TenantSpec as JSpec
from repro.serving import configure as jconfigure
from repro.traffic import VirtualClock as JClock
from repro.traffic import make_traffic as jmake_traffic
from repro.traffic import replay_tenants as jreplay_tenants
import repro_torch.serving.server as server
from repro_torch.convert import load_reference_params
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import PSConfig
from repro_torch.serving import (ArbiterConfig, BatcherConfig,
                                 ServingSession, TenantManager, TenantSpec,
                                 configure)
from repro_torch.storage import (PoolStorage, TenantStorage,
                                 UnknownBackendError)
from repro_torch.traffic import VirtualClock, make_traffic, replay_tenants

ROWS, DIM, F = 400, 16, 4
TOL = dict(rtol=1e-4, atol=1e-5)
PS = dict(hot_rows=64, warm_slots=64, warm_backing="device",
          fused_lookup=True)


def _cfgs(tables, pooling, storage="device"):
    kw = dict(dense_features=F, bottom_mlp=(32, DIM), top_mlp=(16, 1))
    return (DLRMConfig(embedding=EmbeddingStageConfig(
                num_tables=tables, rows=ROWS, dim=DIM, pooling=pooling,
                storage=storage), **kw),
            JConfig(embedding=JStage(num_tables=tables, rows=ROWS, dim=DIM,
                                     pooling=pooling, backend="xla",
                                     storage="device"), **kw))


def _tenant(name, tables, pooling, seed):
    """(port spec, port device oracle, jax spec) on the JAX init's
    params."""
    cfg, jcfg = _cfgs(tables, pooling)
    jmodel = JDLRM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = load_reference_params(DLRM(cfg, device="cpu"), tree)
    oracle = load_reference_params(DLRM(cfg, device="cpu"), tree)
    return (TenantSpec(name=name, model=model), oracle,
            JSpec(name=name, model=jmodel, params=params))


def _managers(tenants, **kw):
    """The port's manager and the JAX one over the same tenants."""
    kw.setdefault("batcher", (BatcherConfig(max_batch=8, max_wait_s=0.002),
                              JBatcherConfig(max_batch=8, max_wait_s=0.002)))
    port_b, jax_b = kw.pop("batcher")
    arb = kw.pop("arbiter", None)
    clock = kw.pop("clock", False)
    mgr = TenantManager([t[0] for t in tenants], batcher=port_b,
                        num_shards=2, ps_cfg=PSConfig(**PS),
                        controllers=configure(arbiter=arb),
                        clock=VirtualClock() if clock else None, **kw)
    jmgr = JManager([t[2] for t in tenants], batcher=jax_b, num_shards=2,
                    ps_cfg=JPSConfig(**PS),
                    controllers=jconfigure(arbiter=None if arb is None
                                           else JArbiter(**dataclasses.asdict(
                                               arb))),
                    clock=JClock() if clock else None, **kw)
    return mgr, jmgr


def _query(rng, spec, batch=4):
    cfg = spec.model.cfg
    dense = rng.normal(size=(batch, F)).astype(np.float32)
    idx = rng.integers(0, ROWS, size=(batch, cfg.embedding.num_tables,
                                      cfg.embedding.pooling)).astype(np.int32)
    return dense, idx


def _forward(model, dense, idx):
    with torch.inference_mode():
        return model(torch.from_numpy(dense), torch.from_numpy(idx)).numpy()


def _jforward(spec, dense, idx):
    return np.array(spec.model.forward(spec.params, dense, idx))


# ---------------------------------------------------------------------------
# bit-exactness on one shared backend
# ---------------------------------------------------------------------------

def test_two_tenants_exact_on_shared_sharded_backend():
    a, b = _tenant("a", 3, 5, 0), _tenant("b", 5, 3, 1)
    mgr, jmgr = _managers([a, b])
    rng = np.random.default_rng(0)
    with mgr, jmgr:
        assert mgr.names == jmgr.names == ["a", "b"]
        assert isinstance(a[0].model.ebc.storage, TenantStorage)
        for _ in range(3):        # interleaved traffic shares the backend
            for spec, oracle, jspec in (a, b):
                dense, idx = _query(rng, spec)
                got = _forward(spec.model, dense, idx)
                np.testing.assert_array_equal(got,
                                              _forward(oracle, dense, idx))
                torch.testing.assert_close(
                    torch.from_numpy(got),
                    torch.from_numpy(_jforward(jspec, dense, idx)), **TOL)
        # each tenant's units are tenant-pure, on the namespace's columns
        for u in mgr.shared._units:
            ns = mgr.shared.tenants[u.tenant]
            assert all(ns.owns(int(t)) for t in u.table_ids)
            np.testing.assert_array_equal(u.cols, u.table_ids - ns.start)
        assert [(u.tenant, list(u.table_ids)) for u in mgr.shared._units] \
            == [(u.tenant, list(u.table_ids)) for u in jmgr.shared._units]
        with pytest.raises(RuntimeError, match="tenancy"):
            mgr.shared.lookup(idx)
        with pytest.raises(RuntimeError, match="tenancy"):
            mgr.shared.begin_update(1)
        assert mgr.shared.plan_migration() is None
        view = mgr.views["a"]
        assert not view.capabilities().migratable
        assert view.capabilities().fused_lookup
        assert view.plan_migration() is None
        assert view.install_migration(None) == {"migrated": False}
        with pytest.raises(RuntimeError, match="already-built"):
            view.build()
    assert mgr.shared.stats()["num_shards"] == 0       # the manager closed
    with pytest.raises(ValueError, match="migration is disabled"):
        mgr.shared.build(PSConfig(**PS), tenants={"x": 8},
                         migration_threshold=1.1)


def test_geometry_names_and_backend_checks():
    a = _tenant("a", 3, 5, 0)
    cfg = dataclasses.replace(a[0].model.cfg, bottom_mlp=(32, 2 * DIM),
                              embedding=dataclasses.replace(
                                  a[0].model.cfg.embedding, dim=2 * DIM))
    bad = TenantSpec(name="b", model=DLRM(cfg, device="cpu"))
    with pytest.raises(ValueError, match="dim"):
        TenantManager([a[0], bad], ps_cfg=PSConfig(**PS))
    with pytest.raises(ValueError, match="duplicate"):
        TenantManager([a[0], dataclasses.replace(a[0])],
                      ps_cfg=PSConfig(**PS))
    with pytest.raises(ValueError, match="at least one"):
        TenantManager([])
    with pytest.raises(ValueError, match="scheduling"):
        TenantManager([a[0]], scheduling="lifo")
    with pytest.raises(UnknownBackendError, match="available"):
        TenantManager([a[0]], backend="nope", ps_cfg=PSConfig(**PS))
    # the process pool is a shared backend too (static tenancy)
    with TenantManager([a[0]], backend="pool", ps_cfg=PSConfig(**PS),
                       num_workers=1) as mgr:
        assert isinstance(mgr.shared, PoolStorage)
        assert list(mgr.shared.tenants) == ["a"]
        with pytest.raises(RuntimeError, match="static"):
            mgr.add_tenant(_tenant("c", 2, 5, 3)[0])
    assert a[0].model.ebc.storage.shared is mgr.shared
    # a per-tenant arbiter is the manager's controller, not the tenant's
    spec = dataclasses.replace(a[0], controllers=configure(
        arbiter=ArbiterConfig()))
    with pytest.raises(ValueError, match="MANAGER"):
        TenantManager([spec], ps_cfg=PSConfig(**PS))
    # and a single session keeps refusing it, pointing at the manager
    with pytest.raises(ValueError, match="TenantManager"):
        ServingSession(a[1], controllers=configure(arbiter=ArbiterConfig()))


# ---------------------------------------------------------------------------
# tenant-scoped stats: schema, merge law, equal to the JAX manager's
# ---------------------------------------------------------------------------

def test_stats_schema_merge_law_and_jax_counters():
    a, b = _tenant("a", 3, 5, 0), _tenant("b", 5, 3, 1)
    mgr, jmgr = _managers([a, b])
    rng = np.random.default_rng(1)
    with mgr, jmgr:
        for _ in range(2):
            for spec, _, jspec in (a, b):
                dense, idx = _query(rng, spec)
                _forward(spec.model, dense, idx)
                _jforward(jspec, dense, idx)
        st, jst = mgr.stats(), jmgr.stats()
        assert set(st) == {"tenants", "shared"}
        assert sorted(st["tenants"]) == ["a", "b"]
        assert st["shared"]["num_tenants"] == 2
        for name, rep in st["tenants"].items():
            assert rep["tenant"] == name
            assert (rep["hot_hits"] + rep["warm_hits"] + rep["cold_misses"]
                    == rep["total_accesses"] > 0)
        for key in ("total_accesses", "hot_hits", "warm_hits",
                    "cold_misses", "device_bytes"):
            assert st["shared"][key] == sum(
                t[key] for t in st["tenants"].values()), key
        for key in ("total_accesses", "hot_hits", "warm_hits",
                    "cold_misses", "evictions", "device_bytes",
                    "num_shards"):
            assert st["shared"][key] == jst["shared"][key], key
            for name in ("a", "b"):
                assert st["tenants"][name][key] \
                    == jst["tenants"][name][key], (name, key)
        pct = mgr.percentiles()
        assert set(pct) == {"tenants", "shared"}
        assert pct["shared"] == {"num_tenants": 2, "scheduling": "fair"}


def test_single_tenant_report_stays_flat():
    a = _tenant("a", 3, 5, 0)
    mgr, jmgr = _managers([a])
    rng = np.random.default_rng(2)
    dense, idx = _query(rng, a[0])
    with mgr, jmgr:
        for m in (mgr, jmgr):
            m.submit_batch("a", dense, idx)
            m.drain()
        pct, jpct = mgr.percentiles(), jmgr.percentiles()
        assert "tenants" not in pct and pct["served"] == len(dense)
        assert pct["num_tenants"] == 1 and pct["scheduling"] == "fair"
        assert set(jpct) - set(pct) == set(), set(jpct) - set(pct)


# ---------------------------------------------------------------------------
# the arbiter on a real shared backend
# ---------------------------------------------------------------------------

def test_arbiter_conserves_budget_and_equals_jax():
    """The same traffic through both managers: the same arbiter rounds
    (shares, per-tenant budgets, depths), every round within the one
    shared budget, and the retuned device bytes inside it."""
    a, b = _tenant("a", 3, 5, 0), _tenant("b", 5, 3, 1)
    arb = ArbiterConfig(every_batches=3, budget_fallback_bytes=150_000,
                        min_share=0.1, depth_min=1, depth_max=6)
    mgr, jmgr = _managers([a, b], arbiter=arb, batcher=(
        BatcherConfig(max_batch=4, max_wait_s=0.0),
        JBatcherConfig(max_batch=4, max_wait_s=0.0)))
    rng = np.random.default_rng(3)
    with mgr, jmgr:
        assert mgr.arbiter.enabled
        for step in range(12):
            # a flash crowd on "a" in the middle third
            for spec, _, _ in (a, b):
                n = 3 if (spec.name == "a" and 4 <= step < 8) else 1
                for _ in range(n):
                    dense, idx = _query(rng, spec)
                    for m in (mgr, jmgr):
                        m.submit_batch(spec.name, dense, idx)
            for m in (mgr, jmgr):
                while m.poll(force=True):
                    pass
        ev, jev = mgr.arbiter.events, jmgr.arbiter.events
        assert len(ev) >= 4 and ev == jev
        for e in ev:
            assert sum(e["budgets"].values()) <= e["budget_bytes"]
            assert sum(e["shares"].values()) == pytest.approx(1.0)
        assert max(e["shares"]["a"] for e in ev) > 0.5
        assert mgr.stats()["shared"]["device_bytes"] \
            <= arb.budget_fallback_bytes
        assert mgr.percentiles()["shared"] == jmgr.percentiles()["shared"]


# ---------------------------------------------------------------------------
# elastic tenancy: attach / detach while serving
# ---------------------------------------------------------------------------

def test_add_remove_tenant_while_serving_keeps_siblings_exact():
    a, b = _tenant("a", 3, 5, 0), _tenant("b", 5, 3, 1)
    arb = ArbiterConfig(every_batches=2, budget_fallback_bytes=1 << 20)
    mgr, _ = _managers([a, b], arbiter=arb)
    rng = np.random.default_rng(4)
    with mgr:
        da, ia = _query(rng, a[0])
        ra = _forward(a[1], da, ia)
        np.testing.assert_array_equal(_forward(a[0].model, da, ia), ra)
        before = [u.ps for u in mgr.shared._units]
        c = _tenant("c", 2, 4, 4)
        mgr.add_tenant(c[0], trace=rng.integers(0, ROWS, (8, 2, 4)))
        assert mgr.names == ["a", "b", "c"]
        assert [u.ps for u in mgr.shared._units][:len(before)] == before
        assert mgr.shared.tenants["c"].start == 8
        assert "c" in mgr.arbiter.views
        dc, ic = _query(rng, c[0])
        np.testing.assert_array_equal(_forward(c[0].model, dc, ic),
                                      _forward(c[1], dc, ic))
        np.testing.assert_array_equal(_forward(a[0].model, da, ia), ra)
        mgr.submit_batch("c", dc, ic)
        mgr.drain()
        assert mgr.stats()["shared"]["num_tenants"] == 3
        with pytest.raises(ValueError, match="already"):
            mgr.add_tenant(b[0])
        mgr.remove_tenant("c")
        assert mgr.names == ["a", "b"] and "c" not in mgr.arbiter.views
        with pytest.raises(KeyError):
            mgr.session("c")
        with pytest.raises(KeyError, match="unknown tenant"):
            mgr.shared.tenant_stats("c")
        assert [u.ps for u in mgr.shared._units] == before
        db, ib = _query(rng, b[0])
        np.testing.assert_array_equal(_forward(b[0].model, db, ib),
                                      _forward(b[1], db, ib))
        np.testing.assert_array_equal(_forward(a[0].model, da, ia), ra)


def test_tenant_updates_touch_only_their_tenant():
    a, b = _tenant("a", 3, 5, 0), _tenant("b", 5, 3, 1)
    mgr, _ = _managers([a, b])
    rng = np.random.default_rng(5)
    with mgr:
        rows = np.array([1, 7, 9])
        vals = rng.normal(size=(3, DIM)).astype(np.float32)
        va, oracle = mgr.views["a"], a[1]
        assert va.begin_update(1) and oracle.ebc.storage.begin_update(1)
        for s in (va, oracle.ebc.storage):
            s.apply_update(2, rows, vals)
        res = va.commit_update(1)
        oracle.ebc.storage.commit_update(1)
        assert res["tenant"] == "a" and va.version() == 1
        assert mgr.views["b"].version() == 0
        da, ia = _query(rng, a[0])
        ia[:, 2, 0] = 7
        np.testing.assert_array_equal(_forward(a[0].model, da, ia),
                                      _forward(oracle, da, ia))
        db, ib = _query(rng, b[0])
        np.testing.assert_array_equal(_forward(b[0].model, db, ib),
                                      _forward(b[1], db, ib))
        assert va.begin_update(2) and va.abort_update(2)
        assert va.version() == 1


# ---------------------------------------------------------------------------
# replay_tenants: counts and the noisy neighbour on a virtual clock
# ---------------------------------------------------------------------------

def _fake_time(service_s):
    """A `time` stand-in whose perf_counter advances `service_s` a call:
    the server reads it once before and once after each batch, so every
    batch serves in exactly `service_s` of virtual time."""
    t = [0.0]

    def perf_counter():
        t[0] += service_s
        return t[0]
    return types.SimpleNamespace(perf_counter=perf_counter)


def _streams(maker, base=400.0):
    return {
        "steady": maker("steady", base_qps=base, dense_features=F,
                        num_tables=3, pooling=4, rows=ROWS,
                        seed=2).queries(60),
        "flash": maker("flash", base_qps=base, dense_features=F,
                       num_tables=3, pooling=4, rows=ROWS,
                       spike_qps=100 * base, spike_start_s=0.02,
                       spike_len_s=0.08, seed=3).queries(240)}


def _noisy(monkeypatch, scheduling, arbiter):
    monkeypatch.setattr(server, "time", _fake_time(0.004))
    monkeypatch.setattr(jserver, "time", _fake_time(0.004))
    tenants = [_tenant("steady", 3, 4, 0), _tenant("flash", 3, 4, 1)]
    cfg = (BatcherConfig(max_batch=8, max_wait_s=0.004),
           JBatcherConfig(max_batch=8, max_wait_s=0.004))
    mgr, jmgr = _managers(tenants, scheduling=scheduling, batcher=cfg,
                          arbiter=arbiter, clock=True)
    with mgr, jmgr:
        reps = replay_tenants(mgr, _streams(make_traffic), window_queries=32)
        jreps = jreplay_tenants(jmgr, _streams(jmake_traffic),
                                window_queries=32)
        pct = mgr.percentiles()
        jpct = jmgr.percentiles()
    out = {}
    for name in ("steady", "flash"):
        r, j = reps[name], jreps[name]
        assert (r.submitted, r.admitted, r.shed, r.served) \
            == (j.submitted, j.admitted, j.shed, j.served)
        assert r.served == r.submitted == (60 if name == "steady" else 240)
        assert [(s.t_s, s.served, s.queue_len) for s in r.timeline] \
            == [(s.t_s, s.served, s.queue_len) for s in j.timeline]
        p, jp = pct["tenants"][name], jpct["tenants"][name]
        for k in ("p50_ms", "p99_ms", "served", "hot_hits", "warm_hits",
                  "cold_misses"):
            assert p[k] == pytest.approx(jp[k], rel=1e-12), (name, k)
        out[name] = p["p99_ms"]
    return out


def test_replay_tenants_equals_jax_and_fair_contains_the_flash(monkeypatch):
    """Per-tenant counts, timelines and percentiles equal the JAX
    package's; fair scheduling + the arbiter keep the steady tenant's p99
    under half of its p99 under fifo without one (the reference's
    noisy-neighbour invariant), and within the flash tenant's own."""
    fair = _noisy(monkeypatch, "fair", ArbiterConfig(
        every_batches=8, budget_fallback_bytes=1 << 20))
    fifo = _noisy(monkeypatch, "fifo", None)
    assert fair["steady"] < 0.5 * fifo["steady"], (fair, fifo)
    assert fair["steady"] <= fair["flash"]


def test_replay_tenants_needs_a_virtual_clock_and_known_tenants():
    a = _tenant("a", 3, 5, 0)
    with TenantManager([a[0]], ps_cfg=PSConfig(**PS)) as mgr:
        with pytest.raises(TypeError, match="VirtualClock"):
            replay_tenants(mgr, {})
    with TenantManager([a[0]], ps_cfg=PSConfig(**PS),
                       clock=VirtualClock()) as mgr:
        with pytest.raises(KeyError, match="unattached"):
            replay_tenants(mgr, {"zzz": []})
