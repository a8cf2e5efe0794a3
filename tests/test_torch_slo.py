"""The port's SLO overload serving against the JAX package's.

Admission shedding, the SLO ladder and the depth hand-off are pure host
logic: the same inputs must give the same decisions in both packages,
exactly — the same sheds and reasons, the same levels, actions, depths
and batch sizes for a scripted latency sequence, the same tuner moves
over 2,000 batches. Degraded (warm-cache-only) serving is held at the
parameter-server level (same rows, zeros and counters as the JAX server;
the L2 delta within 1e-9 relative, a float sum) and at the session
level, where every answer that is not degraded equals the port's dense
path bit for bit under a flash-crowd replay (the law).
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.core import make_pattern
from repro.ps import ParameterServer as JServer
from repro.ps import PSConfig as JPSConfig
from repro.ps import tuning as jtuning
from repro_torch import serving
from repro_torch.core.embedding import (EmbeddingStageConfig,
                                        _pool_rows_core)
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import ParameterServer, PSConfig, tuning
from repro_torch.serving import (Batcher, BatcherConfig, Query,
                                 QueryShedError, ServingSession, SLOConfig,
                                 SLOController, windowed_p99_ms)
from repro_torch.storage import StorageCapabilities
from repro_torch.traffic import VirtualClock, make_traffic, replay

ROWS, TABLES, DIM, POOL = 256, 4, 32, 6


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(TABLES, ROWS, DIM)).astype(np.float32)


def _pats():
    return [make_pattern("med_hot", ROWS, seed=t) for t in range(TABLES)]


def _batch(pats, batch, seed):
    return np.stack([p.sample(batch, POOL, seed=seed * 100 + t)
                     for t, p in enumerate(pats)], axis=1).astype(np.int32)


def _gather(tables, idx):
    """Dense-gather reference: rows [B, T, L, D] straight from the tables."""
    return tables[np.arange(TABLES).reshape(1, TABLES, 1), idx]


def _query(qid, mod=serving):
    return mod.Query(qid=qid, dense=np.zeros(4, np.float32),
                     indices=np.zeros((TABLES, POOL), np.int32))


def _both_batchers(**cfg):
    return (Batcher(BatcherConfig(**cfg)),
            jserving.Batcher(jserving.BatcherConfig(**cfg)))


def _submit_all(b, mod, qids):
    """Submit `qids`; the outcome of each (admitted, or the shed's reason,
    queue length and predicted wait)."""
    out = []
    for i in qids:
        try:
            b.submit(_query(i, mod))
            out.append("ok")
        except mod.QueryShedError as e:
            out.append((e.reason, e.qid, e.queue_len, e.predicted_wait_s))
    return out


# ---------------------------------------------------------------------------
# typed admission rejections, the same as the JAX batcher's
# ---------------------------------------------------------------------------

def test_queue_full_shed_is_typed_not_silent():
    b, jb = _both_batchers(max_batch=4, max_queue=2)
    assert _submit_all(b, serving, range(2)) == ["ok", "ok"]
    with pytest.raises(QueryShedError) as ei:
        b.submit(_query(2))
    err = ei.value
    assert err.reason == "queue_full"
    assert err.qid == 2 and err.queue_len == 2
    assert "queue_full" in str(err)
    assert [q.qid for q in b.queue] == [0, 1]
    assert b.shed == 1 and b.shed_reasons["queue_full"] == 1
    assert _submit_all(jb, jserving, range(3)) == ["ok", "ok", (
        "queue_full", 2, 2, None)]
    assert dict(jb.shed_reasons) == dict(b.shed_reasons)


def test_deadline_shed_is_typed_and_carries_the_prediction():
    outcomes = []
    for b, mod in zip(_both_batchers(max_batch=4, deadline_ms=5.0),
                      (serving, jserving)):
        for _ in range(8):
            b.observe_service(0.004)    # EWMA converges to 4ms per batch
        outcomes.append((_submit_all(b, mod, range(9)), b.service_ewma_s,
                         dict(b.shed_reasons)))
    assert outcomes[0] == outcomes[1]
    log, ewma, reasons = outcomes[0]
    assert log[:8] == ["ok"] * 8
    reason, qid, _, wait = log[8]
    assert reason == "deadline" and qid == 8
    assert wait == pytest.approx(2 * ewma) and wait > 0.005
    assert reasons == {"deadline": 1}


def test_empty_queue_always_admits_even_with_slow_ewma():
    for b, mod in zip(_both_batchers(max_batch=4, deadline_ms=1.0),
                      (serving, jserving)):
        b.observe_service(10.0)         # EWMA far beyond any deadline
        b.submit(_query(0, mod))
        assert len(b.queue) == 1 and b.shed == 0


def test_deadline_needs_a_service_estimate():
    for b, mod in zip(_both_batchers(max_batch=2, deadline_ms=0.001),
                      (serving, jserving)):
        assert _submit_all(b, mod, range(10)) == ["ok"] * 10
        assert len(b.queue) == 10 and b.shed == 0


def test_queue_stays_bounded_under_overload():
    logs = []
    for b, mod in zip(_both_batchers(max_batch=4, max_queue=16),
                      (serving, jserving)):
        log = []
        for i in range(100):
            log += _submit_all(b, mod, [i])
            assert len(b.queue) <= 16
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0].count("ok") == 16 and len(logs[0]) - 16 == 84


# ---------------------------------------------------------------------------
# degraded (warm-cache-only) serving at the parameter-server level
# ---------------------------------------------------------------------------

def _ps_pair(tables, trace, **cfg):
    return (ParameterServer(tables, PSConfig(**cfg), trace=trace,
                            device="cpu"),
            JServer(tables, JPSConfig(**cfg), trace=trace))


def test_degraded_zero_fills_misses_and_measures_the_delta():
    tables = _tables()
    pats = _pats()
    idx0 = _batch(pats, 8, seed=0)
    ps, jps = _ps_pair(tables, idx0, hot_rows=32, warm_slots=16)
    np.testing.assert_array_equal(ps.lookup(idx0), _gather(tables, idx0))
    jps.lookup(idx0)

    assert ps.set_degraded(True) and ps.degraded()
    jps.set_degraded(True)
    idx1 = _batch(pats, 8, seed=1)
    out = ps.lookup(idx1)
    np.testing.assert_array_equal(out, jps.lookup(idx1))
    ref = _gather(tables, idx1)
    hit = np.all(out == ref, axis=-1)
    zero = np.all(out == 0.0, axis=-1)
    assert np.all(hit | zero)           # every row exact or zero-filled
    assert zero[~hit].all() and zero.sum() > 0

    st, jst = ps.stats(), jps.stats()
    assert st["degraded_lookups"] == jst["degraded_lookups"] == 1
    assert st["degraded_rows"] == jst["degraded_rows"] == int(
        np.count_nonzero(~hit))
    measured = float(np.linalg.norm((out - ref).astype(np.float64)))
    assert st["degraded_l2_delta"] == pytest.approx(measured, rel=1e-9)
    assert st["degraded_l2_delta"] == pytest.approx(
        jst["degraded_l2_delta"], rel=1e-9)
    assert (st["hot_hits"] + st["warm_hits"] + st["cold_misses"]
            == st["total_accesses"])

    # leaving the mode restores bit-exactness IMMEDIATELY
    assert ps.set_degraded(False) and not ps.degraded()
    np.testing.assert_array_equal(ps.lookup(idx1), ref)


def test_degraded_blocks_staging_until_restored():
    pats = _pats()
    idx0 = _batch(pats, 8, seed=0)
    for server in _ps_pair(_tables(), idx0, hot_rows=16, warm_slots=16,
                           prefetch_depth=2):
        assert server.can_stage()
        server.set_degraded(True)
        assert not server.can_stage()
        assert not server.stage(idx0)   # no new prefetch work while degraded
        server.set_degraded(False)
        assert server.can_stage()


def test_degraded_delta_monotone_in_cache_hit_rate():
    tables = _tables()
    pats = _pats()
    idx0 = _batch(pats, 16, seed=0)
    idx1 = _batch(pats, 16, seed=1)
    deltas, jdeltas = [], []
    for hot in (8, 64, ROWS):
        ps, jps = _ps_pair(tables, idx0, hot_rows=hot, warm_slots=8)
        for server, out in ((ps, deltas), (jps, jdeltas)):
            server.set_degraded(True)
            server.lookup(idx1)
            out.append(server.stats()["degraded_l2_delta"])
    assert deltas[0] > deltas[1] > deltas[2]
    assert deltas[2] == 0.0
    np.testing.assert_allclose(deltas, jdeltas, rtol=1e-9)


# ---------------------------------------------------------------------------
# SLO escalation ladder (stub storage: pure controller logic), scripted
# identically into the port's controller and the JAX one
# ---------------------------------------------------------------------------

class _StubStorage:
    """Minimal protocol surface the controller touches; records calls."""

    def __init__(self, depth=2, tunable=True, degradable=True):
        self._caps = StorageCapabilities(tunable=tunable,
                                         degradable=degradable)
        self.depth = depth
        self.is_degraded = False
        self.routing_calls = 0
        self.degrade_calls = []

    def capabilities(self):
        return self._caps

    def prefetch_depth(self):
        return self.depth

    def set_prefetch_depth(self, depth):
        self.depth = int(depth)
        return True

    def degraded(self):
        return self.is_degraded

    def set_degraded(self, on):
        self.is_degraded = bool(on)
        self.degrade_calls.append(bool(on))
        return True

    def update_routing(self):
        self.routing_calls += 1
        return None


def _script(mod, latencies, store_kw=None, batcher_kw=None, tuner=None,
            **cfg_kw):
    """Feed one latency level per step (seconds, a full window of it) to
    `mod`'s controller; returns the per-step state and the controller."""
    cfg_kw.setdefault("target_p99_ms", 10.0)
    cfg_kw.setdefault("window_queries", 32)
    cfg_kw.setdefault("check_every_batches", 1)
    store = _StubStorage(**(store_kw or {}))
    batcher = (mod.Batcher(mod.BatcherConfig(**batcher_kw))
               if batcher_kw is not None else None)
    stats = types.SimpleNamespace(query_latencies_s=[])
    ctl = mod.SLOController(mod.SLOConfig(**cfg_kw), store, stats,
                            tuner=tuner, batcher=batcher)
    trace = []
    for lat in latencies:
        stats.query_latencies_s[:] = [lat] * 32
        ctl.step()
        trace.append((ctl.level, store.depth, store.is_degraded,
                      None if batcher is None else
                      (batcher.cfg.max_batch, batcher.cfg.max_wait_s)))
    return trace, ctl, store


def _both(latencies, **kw):
    """The port's run, after checking the JAX run is the same."""
    got = _script(serving, latencies, **kw)
    want = _script(jserving, latencies, **kw)
    assert got[0] == want[0]
    assert got[1].events == want[1].events
    assert got[1].summary() == want[1].summary()
    assert (got[2].routing_calls, got[2].degrade_calls) == (
        want[2].routing_calls, want[2].degrade_calls)
    return got


def test_ladder_escalates_widen_then_degrade_then_recovers():
    trace, ctl, store = _both([0.050] * 3 + [0.009, 0.002, 0.002],
                              max_prefetch_depth=4)
    assert trace[0][:3] == (1, 3, False) and store.routing_calls == 3
    assert trace[1][:3] == (2, 4, True)                 # degrade
    assert trace[2][:3] == (2, 4, True)                 # bounded widen
    assert trace[3][:3] == (2, 4, True)                 # hysteresis band
    assert trace[4][:3] == (1, 4, False)                # exact again first
    assert trace[5][:3] == (0, 2, False)                # base depth back
    assert ctl.breaches == 3 and ctl.degraded_batches >= 1
    assert [e["action"] for e in ctl.events] == [
        "widen", "degrade", "restore_exact", "recover"]


def test_ladder_shrink_rung_between_widen_and_degrade():
    trace, ctl, store = _both(
        [0.050] * 4 + [0.002] * 3, max_prefetch_depth=4, min_batch=4,
        batcher_kw=dict(max_batch=16, max_wait_s=0.008))
    assert [t[0] for t in trace] == [1, 2, 2, 3, 2, 1, 0]
    assert [t[3][0] for t in trace] == [16, 8, 4, 4, 4, 16, 16]
    assert trace[1][3][1] == pytest.approx(0.004)
    assert trace[5][3][1] == pytest.approx(0.008)
    assert [t[2] for t in trace] == [False, False, False, True, False,
                                     False, False]
    assert ctl.batch_shrinks == 2
    assert ctl.summary()["slo_batch_shrinks"] == 2
    assert store.depth == 2
    assert [e["action"] for e in ctl.events] == [
        "widen", "shrink", "shrink", "degrade",
        "restore_exact", "regrow", "recover"]


def test_shrink_rung_needs_both_min_batch_and_batcher():
    trace, ctl, store = _both([0.050] * 2, min_batch=4)   # no batcher
    assert ctl.level == 2 and store.is_degraded
    assert ctl.batch_shrinks == 0
    assert all(e["action"] != "shrink" for e in ctl.events)
    for mod in (serving, jserving):
        with pytest.raises(ValueError, match="min_batch"):
            mod.SLOConfig(target_p99_ms=10.0, min_batch=-1)


def test_ladder_skips_degrade_on_incapable_backend():
    trace, ctl, store = _both([0.050] * 5,
                              store_kw=dict(degradable=False))
    assert ctl.level == 1
    assert store.degrade_calls == [] and not store.is_degraded
    assert ctl.breaches == 5


def test_controller_publishes_depth_ownership_to_tuner():
    for mod in (serving, jserving):
        tuner = types.SimpleNamespace(depth_suspended=False)
        trace, ctl, _ = _script(mod, [0.050], tuner=tuner)
        assert ctl.engaged and tuner.depth_suspended
        stats = ctl.stats
        stats.query_latencies_s[:] = [0.001] * 32
        ctl.step()
        assert not ctl.engaged and not tuner.depth_suspended


def test_windowed_p99_definition():
    lat = [0.001] * 992 + [0.100] * 8
    for fn in (windowed_p99_ms, jserving.windowed_p99_ms):
        assert fn([], 8) is None
        assert fn(lat, 8) == pytest.approx(100.0)
        assert fn(lat, 1000) < 50.0
    for w in (1, 8, 100, 1000, 5000):
        assert windowed_p99_ms(lat, w) == jserving.windowed_p99_ms(lat, w)


def test_slo_config_validates():
    for kw in (dict(target_p99_ms=0.0),
               dict(target_p99_ms=10.0, recover_frac=1.0)):
        for mod in (serving, jserving):
            with pytest.raises(ValueError):
                mod.SLOConfig(**kw)


# ---------------------------------------------------------------------------
# no tug-of-war with the queue-depth auto-tuner (2k batches)
# ---------------------------------------------------------------------------

class _TunerStubStorage(_StubStorage):
    """Adds the counter surface the tuner's depth leg reads. The fed
    signal always argues for NARROWING, the opposite of the SLO
    controller's widening."""

    def __init__(self, depth=2):
        super().__init__(depth=depth)
        self.ready = 0

    def feed_batch(self):
        self.ready += 1

    def stats(self):
        return {"consume_ready": self.ready, "consume_waited": 0}

    def take_prefetch_window_peak(self):
        return 0


def _tug_of_war(mod, tmod):
    store = _TunerStubStorage(depth=4)
    tuner = tmod.AutoTuner(tmod.AutoTuneConfig(
        depth_every_batches=8,
        controller=tmod.QueueDepthController(min_depth=1, max_depth=8)),
        store)
    stats = types.SimpleNamespace(query_latencies_s=[])
    ctl = mod.SLOController(mod.SLOConfig(
        target_p99_ms=10.0, window_queries=64, check_every_batches=4,
        max_prefetch_depth=8), store, stats, tuner=tuner)
    depth_trace, engaged_trace = [], []
    for batch in range(2000):
        overloaded = (batch // 100) % 2 == 0
        stats.query_latencies_s.append(0.050 if overloaded else 0.002)
        store.feed_batch()
        ctl.step()                      # session order: SLO first,
        tuner.step()                    # then the auto-tuner
        depth_trace.append(store.depth)
        engaged_trace.append(ctl.engaged)
    return depth_trace, engaged_trace, tuner, ctl


def test_slo_and_depth_tuner_never_fight_over_2k_batches():
    depth_trace, engaged_trace, tuner, ctl = _tug_of_war(serving, tuning)
    j = _tug_of_war(jserving, jtuning)
    assert (depth_trace, engaged_trace) == (j[0], j[1])
    assert tuner.events == j[2].events and ctl.events == j[3].events

    engaged_batches = {i + 1 for i, e in enumerate(engaged_trace) if e}
    tuner_moves = [e for e in tuner.events if e["kind"] == "depth"]
    assert all(e["batch"] not in engaged_batches for e in tuner_moves)
    for i in range(1, 2000):
        if engaged_trace[i - 1] and engaged_trace[i]:
            assert depth_trace[i] >= depth_trace[i - 1]
    moves = [b - a for a, b in zip(depth_trace, depth_trace[1:]) if a != b]
    flips = sum(1 for x, y in zip(moves, moves[1:]) if (x > 0) != (y > 0))
    assert flips <= 25
    assert tuner_moves
    assert ctl.breaches > 0 and ctl.events


# ---------------------------------------------------------------------------
# session level: flash-crowd replay stays bit-exact; degraded is measured
# ---------------------------------------------------------------------------

def _flash_session(slo, **ps):
    cfg = DLRMConfig(embedding=EmbeddingStageConfig(
        num_tables=TABLES, rows=ROWS, dim=16, pooling=POOL,
        storage="tiered"), bottom_mlp=(32, 16), top_mlp=(16, 1))
    model = DLRM(cfg, device="cpu", seed=0)
    gen = make_traffic("steady", base_qps=100.0, num_tables=TABLES,
                       rows=ROWS, pooling=POOL, seed=0)
    trace = np.stack([q.indices for q in gen.queries(32)])
    model.ebc.storage.build(
        PSConfig(hot_rows=32, warm_slots=32, prefetch_depth=2, **ps),
        trace=trace)
    return ServingSession(
        model, batcher=BatcherConfig(max_batch=16, max_wait_s=0.002),
        slo=slo, clock=VirtualClock())


def _spy_lookups(sess):
    """Record (indices, pooled output, degraded?) of every storage lookup."""
    seen = []
    orig = sess.storage.lookup

    def spy(indices, weights=None, **kw):
        out = orig(indices, weights, **kw)
        seen.append((np.array(indices), out.clone(),
                     sess.storage.degraded()))
        return out
    sess.storage.lookup = spy
    return seen


def _dense_pooled(tables, idx):
    """The port's dense path on the same rows (the law's other side)."""
    return _pool_rows_core(torch.from_numpy(_gather(tables, idx)), None,
                           "sum")


@pytest.mark.parametrize("fused", [False, True])
def test_non_degraded_answers_bit_exact_under_flash_load(fused):
    ps = (dict(warm_backing="device", fused_lookup=True) if fused else {})
    sess = _flash_session(SLOConfig(target_p99_ms=8.0, degrade=False,
                                    shed_deadline_frac=0.5,
                                    check_every_batches=2,
                                    window_queries=64), **ps)
    try:
        tables = sess.storage.ps.cold.tables
        seen = _spy_lookups(sess)
        gen = make_traffic("flash", base_qps=2000.0, spike_qps=40000.0,
                           spike_start_s=0.05, spike_len_s=0.15,
                           num_tables=TABLES, rows=ROWS, pooling=POOL,
                           seed=1)
        rep = replay(sess, gen.queries(1500), window_queries=64)
        assert rep.shed > 0             # the spike genuinely overloaded it
        assert rep.served == rep.admitted > 0
        assert not sess.storage.degraded()
        assert rep.percentiles["slo_degraded_batches"] == 0
        assert seen
        for idx, out, degraded in seen:     # bit-identical, not just close
            assert not degraded
            assert torch.equal(out, _dense_pooled(tables, idx))
    finally:
        sess.close()


def test_session_reports_degraded_counters_in_percentiles():
    sess = _flash_session(SLOConfig(target_p99_ms=50.0),
                          warm_backing="device", fused_lookup=True)
    try:
        assert sess.storage.capabilities().degradable
        assert sess.storage.set_degraded(True)
        tables = sess.storage.ps.cold.tables
        seen = _spy_lookups(sess)
        gen = make_traffic("steady", base_qps=2000.0, num_tables=TABLES,
                           rows=ROWS, pooling=POOL, seed=2)
        rep = replay(sess, gen.queries(200), window_queries=64)
        pct = rep.percentiles
        assert pct["degraded_lookups"] > 0
        assert pct["degraded_rows"] > 0
        assert pct["degraded_l2_delta"] > 0.0
        assert rep.timeline[-1].degraded
        # the degraded answer leaves the zero-filled misses out
        idx, out, degraded = seen[-1]
        assert degraded
        assert not torch.equal(out, _dense_pooled(tables, idx))
    finally:
        sess.close()


def test_session_derives_shed_deadline_from_slo_target():
    sess = _flash_session(SLOConfig(target_p99_ms=20.0,
                                    shed_deadline_frac=0.5))
    try:
        assert sess.server.batcher.cfg.deadline_ms == pytest.approx(10.0)
        assert sess.slo is not None
        assert sess.percentiles() == {}     # nothing served yet
    finally:
        sess.close()
    sess = _flash_session(SLOConfig(target_p99_ms=20.0,
                                    shed_deadline_frac=0.0))
    try:
        assert sess.server.batcher.cfg.deadline_ms == 0.0
    finally:
        sess.close()
