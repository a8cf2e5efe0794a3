"""The port's traffic subsystem against the JAX package's.

`repro_torch.traffic` is a copy of `repro.traffic` (numpy only): the same
arguments must give the same arrival stamps, dense features and indices,
exactly. Replay runs on the port's `ServingSession` on the CPU (the plain
versions of the kernels); queries served under replay are scored as the
JAX session scores them, within `rtol=1e-4, atol=1e-5` (the tolerance of
tests/test_torch_dlrm.py). `plan_admission` is held exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import plan_admission as jplan_admission
from repro.core.embedding import EmbeddingStageConfig as JStage
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro.ps import PSConfig as JPSConfig
from repro.serving import BatcherConfig as JBatcherConfig
from repro.serving import ServingSession as JSession
from repro import traffic as jtraffic
from repro_torch import traffic
from repro_torch.convert import load_reference_params
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.core.plan import plan_admission
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import PSConfig
from repro_torch.serving import BatcherConfig, ServingSession
from repro_torch.traffic import (TRACE_KINDS, DiurnalRate, FlashCrowdRate,
                                 VirtualClock, make_traffic, replay)

ROWS, TABLES, POOL, DIM = 512, 4, 6, 16
TOL = dict(rtol=1e-4, atol=1e-5)


def _gen(kind="steady", mod=traffic, **kw):
    kw.setdefault("base_qps", 100.0)
    kw.setdefault("num_tables", TABLES)
    kw.setdefault("rows", ROWS)
    kw.setdefault("pooling", POOL)
    return mod.make_traffic(kind, **kw)


def _assert_same_stream(a, b):
    assert [q.qid for q in a] == [q.qid for q in b]
    assert [q.arrival_s for q in a] == [q.arrival_s for q in b]
    np.testing.assert_array_equal(np.stack([q.dense for q in a]),
                                  np.stack([q.dense for q in b]))
    np.testing.assert_array_equal(np.stack([q.indices for q in a]),
                                  np.stack([q.indices for q in b]))


# ---------------------------------------------------------------------------
# virtual clock
# ---------------------------------------------------------------------------

def test_virtual_clock_advances_and_rejects_backwards():
    for clk in (VirtualClock(), jtraffic.VirtualClock()):
        assert clk() == 0.0
        assert clk.advance(1.5) == 1.5
        clk.advance(0.0)                # zero advance is legal (no-op)
        assert clk() == clk.now == 1.5
        with pytest.raises(ValueError):
            clk.advance(-0.1)
        assert clk.now == 1.5           # failed advance left time untouched


# ---------------------------------------------------------------------------
# rate profiles
# ---------------------------------------------------------------------------

def test_steady_arrivals_evenly_spaced():
    t = _gen("steady", base_qps=50.0).arrival_times(100)
    assert t[0] == 0.0
    np.testing.assert_allclose(np.diff(t), 1.0 / 50.0)
    np.testing.assert_array_equal(
        t, _gen("steady", jtraffic, base_qps=50.0).arrival_times(100))


def test_diurnal_rate_swings_and_validates():
    prof = DiurnalRate(base_qps=100.0, amplitude=0.5, period_s=10.0)
    jprof = jtraffic.DiurnalRate(base_qps=100.0, amplitude=0.5,
                                 period_s=10.0)
    ts = np.linspace(0.0, 10.0, 500)
    rates = np.array([prof.rate(t) for t in ts])
    assert rates.max() > 140.0 and rates.min() < 60.0
    assert rates.min() > 0.0
    assert rates.tolist() == [jprof.rate(t) for t in ts]
    with pytest.raises(ValueError):
        DiurnalRate(base_qps=100.0, amplitude=1.0)
    t = _gen("diurnal", base_qps=100.0, period_s=10.0).arrival_times(2000)
    assert np.all(np.diff(t) > 0)
    np.testing.assert_array_equal(t, _gen(
        "diurnal", jtraffic, base_qps=100.0, period_s=10.0
    ).arrival_times(2000))


def test_flash_crowd_densifies_the_spike_window():
    kw = dict(base_qps=100.0, spike_qps=1000.0, spike_start_s=1.0,
              spike_len_s=1.0)
    t = _gen("flash", **kw).arrival_times(1300)
    assert np.count_nonzero((t >= 1.0) & (t < 2.0)) > 800
    assert 80 <= np.count_nonzero(t < 1.0) <= 120
    np.testing.assert_array_equal(
        t, _gen("flash", jtraffic, **kw).arrival_times(1300))
    assert FlashCrowdRate(100.0, 1000.0, 1.0, 1.0).in_spike(1.5)
    assert not FlashCrowdRate(100.0, 1000.0, 1.0, 1.0).in_spike(2.5)


# ---------------------------------------------------------------------------
# determinism (the --seed contract), and the same arrays as the JAX copy
# ---------------------------------------------------------------------------

def test_same_args_byte_identical_stream():
    for kind in TRACE_KINDS:
        a = _gen(kind, seed=7).queries(64)
        _assert_same_stream(a, _gen(kind, seed=7).queries(64))
        _assert_same_stream(a, _gen(kind, jtraffic, seed=7).queries(64))
    assert traffic.TRACE_KINDS == jtraffic.TRACE_KINDS


def test_seed_changes_the_stream():
    a = _gen("steady", seed=0).queries(64)
    b = _gen("steady", seed=1).queries(64)
    assert not all(np.array_equal(qa.indices, qb.indices)
                   for qa, qb in zip(a, b))
    assert not np.array_equal(a[0].dense, b[0].dense)
    _assert_same_stream(b, _gen("steady", jtraffic, seed=1).queries(64))


def test_tables_get_distinct_patterns():
    q = _gen("steady", seed=0, hotness="high_hot").queries(64)
    idx = np.stack([x.indices for x in q])          # [N, T, L]
    flat = [idx[:, t].reshape(-1) for t in range(TABLES)]
    assert not all(np.array_equal(flat[0], f) for f in flat[1:])
    _assert_same_stream(q, _gen("steady", jtraffic, seed=0,
                                hotness="high_hot").queries(64))


# ---------------------------------------------------------------------------
# hotness shift
# ---------------------------------------------------------------------------

def test_shift_preserves_pre_stream_and_moves_the_hot_set():
    base = _gen("steady", seed=3).queries(400)
    shifted = _gen("shift", seed=3, shift_at_s=2.0).queries(400)
    _assert_same_stream(shifted, _gen("shift", jtraffic, seed=3,
                                      shift_at_s=2.0).queries(400))
    pre = [i for i, q in enumerate(shifted) if q.arrival_s < 2.0]
    post = [i for i, q in enumerate(shifted) if q.arrival_s >= 2.0]
    assert pre and post
    for i in pre:
        np.testing.assert_array_equal(shifted[i].indices, base[i].indices)

    def top_rows(ids):
        counts = np.bincount(np.concatenate(ids).reshape(-1),
                             minlength=ROWS)
        return set(np.argsort(-counts)[:10].tolist())
    hot_pre = top_rows([shifted[i].indices[:, 0] for i in pre])
    hot_post = top_rows([shifted[i].indices[:, 0] for i in post])
    assert len(hot_pre & hot_post) < 5


def test_make_traffic_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown trace kind"):
        _gen("tsunami")


# ---------------------------------------------------------------------------
# replay on a real session
# ---------------------------------------------------------------------------

def _sessions(clock=True):
    """A JAX and a port tiered session on the same weights and tiers."""
    stage = dict(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL)
    mlp = dict(bottom_mlp=(32, DIM), top_mlp=(16, 1))
    jmodel = JDLRM(JConfig(embedding=JStage(**stage, backend="xla",
                                            storage="tiered"), **mlp))
    params = jmodel.init(jax.random.PRNGKey(0))
    model = DLRM(DLRMConfig(embedding=EmbeddingStageConfig(
        **stage, storage="tiered"), **mlp), device="cpu")
    load_reference_params(model, jax.tree_util.tree_map(np.asarray, params))
    trace = np.stack([q.indices for q in _gen("steady").queries(32)])
    jmodel.ebc.storage.build(params, JPSConfig(hot_rows=64, warm_slots=64),
                             trace=trace)
    model.ebc.storage.build(PSConfig(hot_rows=64, warm_slots=64),
                            trace=trace)
    cfg = dict(max_batch=8, max_wait_s=0.05)
    js = JSession(jmodel, params, batcher=JBatcherConfig(**cfg),
                  clock=jtraffic.VirtualClock() if clock else None)
    ps = ServingSession(model, batcher=BatcherConfig(**cfg),
                        clock=VirtualClock() if clock else None)
    return js, ps


def _tap(sess):
    got = {}
    sess.server.on_batch = lambda batch, scores: got.update(
        {q.qid: float(s) for q, s in zip(batch, scores)})
    return got


def test_replay_requires_a_virtual_clock():
    js, ps = _sessions(clock=False)
    try:
        with pytest.raises(TypeError, match="VirtualClock"):
            replay(ps, _gen("steady").queries(4))
    finally:
        js.close()
        ps.close()


def test_replay_steady_low_load_serves_everything():
    js, ps = _sessions()
    try:
        want = _tap(js)
        got = _tap(ps)
        queries = _gen("steady", seed=1).queries(64)
        jtraffic.replay(js, queries)
        rep = replay(ps, queries)
        assert rep.submitted == 64
        assert rep.shed == 0 and rep.shed_frac == 0.0
        assert rep.admitted == rep.served == 64
        assert rep.percentiles["served"] == 64
        assert rep.percentiles["shed_queries"] == 0
        t = [s.t_s for s in rep.timeline]
        assert t == sorted(t)
        served = [s.served for s in rep.timeline]
        assert served == sorted(served) and served[-1] == 64
        assert all(not s.degraded and s.slo_level == 0
                   for s in rep.timeline)
        assert rep.final_windowed_p99_ms() > 0.0
        # every batch is a partial flushed at its 50 ms deadline: latency
        # never exceeds window + one real service time (generous margin)
        assert all(lat <= 0.05 + 0.25
                   for lat in ps.stats.query_latencies_s)
        # the replayed answers are the JAX session's
        assert sorted(got) == sorted(want) == list(range(64))
        torch.testing.assert_close(torch.tensor([got[q] for q in range(64)]),
                                   torch.tensor([want[q] for q in range(64)]),
                                   **TOL)
    finally:
        js.close()
        ps.close()


def test_replay_snapshots_after_filters_by_time():
    js, ps = _sessions()
    js.close()
    try:
        rep = replay(ps, _gen("steady").queries(32))
        mid = rep.timeline[len(rep.timeline) // 2].t_s
        late = rep.snapshots_after(mid)
        assert late and all(s.t_s >= mid for s in late)
        assert len(late) < len(rep.timeline)
    finally:
        ps.close()


# ---------------------------------------------------------------------------
# admission planning (core.plan), held exactly against the JAX copy
# ---------------------------------------------------------------------------

def test_plan_admission_sizes_queue_from_budget():
    plan = plan_admission(target_p99_ms=10.0, batch_service_ms=2.0,
                          max_batch=32, headroom=0.8)
    assert plan.deadline_ms == pytest.approx(8.0)
    assert plan.batches_in_budget == 4
    assert plan.max_queue == 4 * 32
    assert plan.sustainable_qps == pytest.approx(16000.0)
    assert plan.notes == ()
    j = jplan_admission(target_p99_ms=10.0, batch_service_ms=2.0,
                        max_batch=32, headroom=0.8)
    assert (plan.deadline_ms, plan.max_queue, plan.batches_in_budget,
            plan.sustainable_qps, plan.notes) == (
        j.deadline_ms, j.max_queue, j.batches_in_budget, j.sustainable_qps,
        j.notes)


def test_plan_admission_floors_at_one_batch():
    plan = plan_admission(target_p99_ms=1.0, batch_service_ms=5.0,
                          max_batch=16)
    assert plan.batches_in_budget == 1 and plan.max_queue == 16
    assert plan.notes == jplan_admission(1.0, 5.0, 16).notes != ()


def test_plan_admission_monotone_in_target():
    queues = [plan_admission(t, 2.0, 32).max_queue
              for t in (4.0, 8.0, 16.0, 64.0)]
    assert queues == sorted(queues)
    assert queues == [jplan_admission(t, 2.0, 32).max_queue
                      for t in (4.0, 8.0, 16.0, 64.0)]


@pytest.mark.parametrize("args,kw", [
    ((0.0, 2.0, 32), {}), ((10.0, -1.0, 32), {}), ((10.0, 2.0, 0), {}),
    ((10.0, 2.0, 32), {"headroom": 1.5})])
def test_plan_admission_validates(args, kw):
    for fn in (plan_admission, jplan_admission):
        with pytest.raises(ValueError):
            fn(*args, **kw)
