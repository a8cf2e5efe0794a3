"""The port's runtime auto-tuners against the JAX package's.

`ps.tuning` is host logic over protocol verbs, so the same observations
must give the same decisions, exactly: `QueueDepthController` proposals
for scripted overlap fractions, `AutoTuner` depth moves on scripted
counters, capacity retunes of a tiered session on a fixed fallback
budget (the same tier sizes as the JAX session on the same traffic), and
`BudgetArbiter` shares, budgets and depths. The session legs run the
port's `tiered` backend on the CPU; `device` keeps every hook inert.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.embedding import EmbeddingStageConfig as JStage
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro.ps import PSConfig as JPSConfig
from repro.ps import tuning as jtuning
from repro.serving import BatcherConfig as JBatcherConfig
from repro.serving import ServingSession as JSession
from repro_torch.convert import load_reference_params
from repro_torch.core import make_pattern
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.core.plan import estimate_device_budget
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import (AutoTuneConfig, AutoTuner, ParameterServer,
                            PSConfig, QueueDepthController, tuning)
from repro_torch.ps.prefetch import PrefetchQueue, StagedBatch
from repro_torch.serving import BatcherConfig, ServingSession
from repro_torch.storage import StorageCapabilities

ROWS, TABLES, DIM, POOL = 256, 6, 16, 6
SKEWED = ("one_item", "one_item", "high_hot", "med_hot", "random", "random")
TOL = dict(rtol=1e-4, atol=1e-5)


def _pats(hotness=SKEWED):
    return [make_pattern(h, ROWS, seed=t) for t, h in enumerate(hotness)]


def _batch(pats, batch, seed):
    return np.stack([p.sample(batch, POOL, seed=seed * 100 + t)
                     for t, p in enumerate(pats)], axis=1).astype(np.int32)


def _trace(pats, batches=3, batch=8, seed0=50):
    return np.concatenate([_batch(pats, batch, seed0 + s)
                           for s in range(batches)], axis=0)


def _stage():
    return dict(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL)


def _session_model(storage):
    return DLRM(DLRMConfig(embedding=EmbeddingStageConfig(
        **_stage(), storage=storage), bottom_mlp=(32, DIM),
        top_mlp=(16, 1)), device="cpu", seed=0)


def _serve(sess, pats, n, dense_features=13):
    """n batches of 8, one queued ahead of the executing one."""
    for b in range(n):
        dense = np.zeros((8, dense_features), np.float32)
        sess.submit_batch(dense, _batch(pats, 8, seed=b), qid0=b * 8)
        if b >= 1:
            sess.poll()
    sess.drain()


# ---------------------------------------------------------------------------
# queue-depth controller
# ---------------------------------------------------------------------------

def test_controller_never_leaves_bound_and_converges():
    ctl = QueueDepthController(min_depth=1, max_depth=6)

    def plant(depth):       # overlap improves with depth, saturating at 4
        return min(1.0, 0.25 * depth)

    depth, seen = 1, []
    for _ in range(20):
        depth = ctl.propose(depth, plant(depth), peak_depth=depth)
        seen.append(depth)
        assert ctl.min_depth <= depth <= ctl.max_depth
    assert len(set(seen[-5:])) == 1
    assert ctl.widen_below <= plant(seen[-1])


def test_controller_decisions_equal_jax_on_a_grid():
    kw = dict(min_depth=1, max_depth=5, widen_below=0.4, narrow_above=0.9)
    ctl, jctl = QueueDepthController(**kw), jtuning.QueueDepthController(**kw)
    for depth in range(0, 8):
        for overlap in (None, 0.0, 0.39, 0.4, 0.5, 0.89, 0.9, 1.0):
            for peak in range(0, 7):
                assert ctl.propose(depth, overlap, peak) == \
                    jctl.propose(depth, overlap, peak)


def test_controller_widen_narrow_hold():
    ctl = QueueDepthController(min_depth=1, max_depth=4,
                               widen_below=0.5, narrow_above=0.95)
    assert ctl.propose(2, 0.1, peak_depth=2) == 3        # widen
    assert ctl.propose(4, 0.1, peak_depth=4) == 4        # clamped at max
    assert ctl.propose(3, 1.0, peak_depth=1) == 2        # narrow: unused
    assert ctl.propose(3, 1.0, peak_depth=3) == 3        # full queue: hold
    assert ctl.propose(2, 0.7, peak_depth=2) == 2        # dead band: hold
    assert ctl.propose(1, 1.0, peak_depth=0) == 1        # clamped at min
    assert ctl.propose(2, None, peak_depth=0) == 2       # idle: hold
    assert ctl.propose(99, 0.7, peak_depth=0) == 4       # clamp on entry
    for mod in (tuning, jtuning):
        with pytest.raises(ValueError):
            mod.QueueDepthController(min_depth=0)
        with pytest.raises(ValueError):
            mod.QueueDepthController(widen_below=0.9, narrow_above=0.5)


def test_prefetcher_set_depth_runtime():
    """Depth moves never drop staged work; zero disables staging."""
    q = PrefetchQueue(depth=2, resolver=lambda t, rows: np.zeros(
        (len(rows), 2), np.float32))

    def mk(seed):
        idx = np.full((1, 1, 2), seed, np.int64)
        return StagedBatch(idx, {0: np.arange(2, dtype=np.int64)}, {})

    assert q.stage(mk(0)) and q.stage(mk(1))
    assert not q.can_stage()
    q.set_depth(1)                       # shrink below current occupancy
    assert len(q) == 2                   # nothing dropped
    assert not q.can_stage()
    assert q.consume(np.full((1, 1, 2), 0, np.int64)) is not None
    assert q.consume(np.full((1, 1, 2), 1, np.int64)) is not None
    assert q.can_stage()
    q.set_depth(0)
    assert not q.can_stage()


def test_take_window_peak_resets_between_windows():
    q = PrefetchQueue(depth=4, resolver=lambda t, rows: np.zeros(
        (len(rows), 2), np.float32))

    def mk(seed):
        idx = np.full((1, 1, 2), seed, np.int64)
        return StagedBatch(idx, {0: np.arange(2, dtype=np.int64)}, {})

    q.stage(mk(0))
    q.stage(mk(1))
    assert q.take_window_peak() == 2
    q.consume(np.full((1, 1, 2), 0, np.int64))
    q.consume(np.full((1, 1, 2), 1, np.int64))
    assert q.take_window_peak() == 2   # baseline was len(q)==2 at reset
    assert q.take_window_peak() == 0   # queue empty since
    assert q.max_queue_depth == 2      # lifetime max untouched


# ---------------------------------------------------------------------------
# parameter-server tier resize / retune
# ---------------------------------------------------------------------------

def test_resize_tiers_stays_bit_exact():
    pats = _pats()
    tables = np.random.default_rng(0).normal(
        size=(TABLES, ROWS, DIM)).astype(np.float32)
    ps = ParameterServer(tables, PSConfig(hot_rows=16, warm_slots=16,
                                          window_batches=4),
                         trace=_trace(pats), device="cpu")
    idx = _batch(pats, 8, seed=0)
    want = tables[np.arange(TABLES)[None, :, None], idx]
    assert np.array_equal(ps.lookup(idx), want)
    ps.resize_tiers(48, 8)               # grow hot, shrink warm
    assert ps.cfg.hot_rows == 48 and ps.num_hot == 48
    assert np.array_equal(ps.lookup(idx), want)
    ps.resize_tiers(0, 64)               # hot off entirely
    assert ps.num_hot == 0
    assert np.array_equal(ps.lookup(idx), want)


def test_retune_plans_from_window_and_respects_budget():
    pats = _pats()
    ps = ParameterServer(np.zeros((TABLES, ROWS, DIM), np.float32),
                         PSConfig(hot_rows=4, warm_slots=4,
                                  window_batches=8), device="cpu")
    assert ps.retune(1 << 20) is None    # empty window: nothing to plan
    for s in range(4):
        ps.lookup(_batch(pats, 8, seed=s))
    budget = 64 * 1024
    assert ps.retune(budget) is not None
    cap = ps.cfg.capacity_rows()
    assert TABLES * cap * DIM * 4 <= budget
    assert cap > 8                       # the budget allows growth


# ---------------------------------------------------------------------------
# the session auto-tuning loop (and `device` staying inert)
# ---------------------------------------------------------------------------

def test_session_auto_tunes_depth_within_bounds():
    model = _session_model("tiered")
    pats = _pats()
    model.ebc.storage.build(
        PSConfig(hot_rows=8, warm_slots=8, prefetch_depth=2,
                 async_prefetch=True, window_batches=4),
        trace=_trace(pats))
    assert model.ebc.storage.capabilities().tunable
    ctl = QueueDepthController(min_depth=1, max_depth=4)
    with ServingSession(model,
                        batcher=BatcherConfig(max_batch=8, max_wait_s=0.0),
                        sla_ms=1e6,
                        auto_tune=AutoTuneConfig(depth_every_batches=2,
                                                 controller=ctl)) as sess:
        _serve(sess, pats, 10)
        pct = sess.percentiles()
    assert "prefetch_depth" in pct
    assert ctl.min_depth <= pct["prefetch_depth"] <= ctl.max_depth
    assert pct["depth_retunes"] == len(sess.tuner.events)
    for e in sess.tuner.events:
        assert ctl.min_depth <= e["to"] <= ctl.max_depth


def test_auto_tuner_never_reenables_disabled_staging():
    model = _session_model("tiered")
    pats = _pats()
    model.ebc.storage.build(
        PSConfig(hot_rows=8, warm_slots=8, prefetch_depth=0,
                 window_batches=4), trace=_trace(pats))
    assert model.ebc.storage.capabilities().tunable
    with ServingSession(model,
                        batcher=BatcherConfig(max_batch=8, max_wait_s=0.0),
                        sla_ms=1e6,
                        auto_tune=AutoTuneConfig(depth_every_batches=2)
                        ) as sess:
        _serve(sess, pats, 6)
        assert model.ebc.storage.prefetch_depth() == 0
    assert sess.tuner.events == []


class _FakeStorage:
    """Minimal tunable storage fed scripted counter readings."""

    def __init__(self, depth, readings, peaks):
        self.depth = depth
        self.readings = list(readings)
        self.peaks = list(peaks)

    def capabilities(self):
        return StorageCapabilities(tunable=True)

    def stats(self):
        return self.readings.pop(0) if len(self.readings) > 1 \
            else self.readings[0]

    def prefetch_depth(self):
        return self.depth

    def set_prefetch_depth(self, d):
        self.depth = d
        return True

    def take_prefetch_window_peak(self):
        return self.peaks.pop(0) if self.peaks else 0


def _scripted(mod, depth, readings, peaks, steps, **cfg):
    store = _FakeStorage(depth, readings, peaks)
    tuner = mod.AutoTuner(mod.AutoTuneConfig(**cfg), store)
    depths = []
    for _ in range(steps):
        tuner.step()
        depths.append(store.depth)
    return depths, tuner.events


def test_auto_tuner_narrows_from_window_peak_not_lifetime_max():
    """Narrowing uses the per-window queue peak: the lifetime max would
    block reclaiming dead slots forever after one burst."""
    readings = [{"consume_ready": 10 * i, "consume_waited": 0}
                for i in range(6)]
    kw = dict(depth_every_batches=1,
              controller=QueueDepthController(min_depth=1, max_depth=4))
    depths, events = _scripted(tuning, 4, readings, [4, 1, 1, 1], 3, **kw)
    assert depths == [4, 3, 2]
    jkw = dict(kw, controller=jtuning.QueueDepthController(min_depth=1,
                                                           max_depth=4))
    assert (depths, events) == _scripted(jtuning, 4, readings, [4, 1, 1, 1],
                                         3, **jkw)


def test_auto_tuner_treats_nonpositive_delta_as_idle():
    readings = [{"consume_ready": 50, "consume_waited": 0},
                {"consume_ready": 0, "consume_waited": 0}]
    for mod in (tuning, jtuning):
        depths, events = _scripted(mod, 2, readings, [], 1,
                                   depth_every_batches=1)
        assert events == [] and depths == [2]


def test_auto_tuner_snapshot_postdates_warmup_reset():
    """A second session on a pre-used storage must not see the
    pre-warmup counters — negative deltas would fabricate an overlap."""
    model = _session_model("tiered")
    pats = _pats()
    cfg = PSConfig(hot_rows=8, warm_slots=8, prefetch_depth=2,
                   async_prefetch=True, window_batches=4)
    model.ebc.storage.build(cfg, trace=_trace(pats))
    with ServingSession(model,
                        batcher=BatcherConfig(max_batch=8, max_wait_s=0.0),
                        sla_ms=1e6) as s1:
        _serve(s1, pats, 4)
    model.ebc.storage.build(cfg, trace=_trace(pats))
    sess = ServingSession(model,
                          batcher=BatcherConfig(max_batch=8, max_wait_s=0.0),
                          sla_ms=1e6,
                          auto_tune=AutoTuneConfig(depth_every_batches=2))
    try:
        assert sess.tuner._last == {"consume_ready": 0, "consume_waited": 0}
    finally:
        sess.close()


def test_device_backend_ignores_tuning_hooks():
    model = _session_model("device")
    store = model.ebc.storage
    caps = store.capabilities()
    assert not caps.tunable and not caps.migratable
    assert store.prefetch_depth() == 0
    assert store.set_prefetch_depth(7) is False
    assert store.prefetch_depth() == 0
    assert store.retune_capacities(1 << 30) is None
    assert store.update_routing() is None
    assert store.plan_migration() is None
    assert store.install_migration(None) == {"migrated": False}
    with ServingSession(model,
                        batcher=BatcherConfig(max_batch=8, max_wait_s=0.0),
                        sla_ms=1e6, auto_tune=True) as sess:
        assert sess.tuner is not None and not sess.tuner.enabled
        _serve(sess, _pats(), 1)
        pct = sess.percentiles()
    assert sess.tuner.events == []
    assert "prefetch_depth" not in pct and "depth_retunes" not in pct


def test_capacity_retune_through_session_equals_jax():
    """The capacity leg on a fixed fallback budget: the same tier sizes
    at the same batches as the JAX session on the same traffic, and the
    same scores (within the tolerance) after the tiers moved."""
    pats = _pats()
    stage = _stage()
    mlp = dict(bottom_mlp=(32, DIM), top_mlp=(16, 1))
    jmodel = JDLRM(JConfig(embedding=JStage(**stage, backend="xla",
                                            storage="tiered"), **mlp))
    params = jmodel.init(jax.random.PRNGKey(0))
    model = _session_model("tiered")
    load_reference_params(model, jax.tree_util.tree_map(np.asarray, params))
    ps_kw = dict(hot_rows=4, warm_slots=4, window_batches=8)
    jmodel.ebc.storage.build(params, JPSConfig(**ps_kw), trace=_trace(pats))
    model.ebc.storage.build(PSConfig(**ps_kw), trace=_trace(pats))
    tune = dict(depth_every_batches=0, capacity_every_batches=3,
                budget_fallback_bytes=64 * 1024 * TABLES,
                budget_fraction=1.0)
    cfg = dict(max_batch=8, max_wait_s=0.0)
    scores = []
    with JSession(jmodel, params, batcher=JBatcherConfig(**cfg), sla_ms=1e6,
                  auto_tune=jtuning.AutoTuneConfig(**tune)) as js, \
            ServingSession(model, batcher=BatcherConfig(**cfg), sla_ms=1e6,
                           auto_tune=AutoTuneConfig(**tune)) as ps:
        for sess in (js, ps):
            got = {}
            sess.server.on_batch = lambda b, s, got=got: got.update(
                {q.qid: float(x) for q, x in zip(b, s)})
            _serve(sess, pats, 8)
            scores.append(got)
        pct, jpct = ps.percentiles(), js.percentiles()
        cap_rows = model.ebc.storage.ps.cfg.capacity_rows()
    caps = [e for e in ps.tuner.events if e["kind"] == "capacity"]
    assert caps and pct["capacity_retunes"] == len(caps)
    assert cap_rows > 8
    assert ps.tuner.events == js.tuner.events
    assert pct["capacity_retunes"] == jpct["capacity_retunes"]
    qids = sorted(scores[0])
    assert qids == sorted(scores[1]) == list(range(64))
    torch.testing.assert_close(torch.tensor([scores[1][q] for q in qids]),
                               torch.tensor([scores[0][q] for q in qids]),
                               **TOL)


def test_estimate_device_budget_fallback():
    """Without a card the estimate is the fallback (None = skip the
    capacity step), as the JAX estimate is on a device without memory
    stats."""
    assert estimate_device_budget(fallback_bytes=123, device="cpu") == 123
    assert estimate_device_budget(device="cpu") is None
    if not torch.cuda.is_available():
        assert estimate_device_budget(fallback_bytes=7) == 7


# ---------------------------------------------------------------------------
# the cross-tenant arbiter (ported for configure(); driven by a tenant
# manager in a later slice): the same shares, budgets and depths
# ---------------------------------------------------------------------------

class _View:
    def __init__(self, depth):
        self.depth = depth
        self.accesses = 0
        self.budgets = []

    def capabilities(self):
        return StorageCapabilities(tunable=True)

    def stats(self):
        return {"total_accesses": self.accesses}

    def retune_capacities(self, budget):
        self.budgets.append(budget)

    def prefetch_depth(self):
        return self.depth

    def set_prefetch_depth(self, d):
        self.depth = d
        return True


@pytest.mark.parametrize("engaged", [frozenset(), frozenset({"b"})])
def test_budget_arbiter_equals_jax(engaged):
    runs = []
    for mod in (tuning, jtuning):
        views = {"a": _View(4), "b": _View(4), "c": _View(4)}
        arb = mod.BudgetArbiter(mod.ArbiterConfig(
            every_batches=2, budget_fallback_bytes=1 << 20,
            min_share=0.1), views)
        for step, load in enumerate([(90, 5, 5), (10, 10, 80), (0, 0, 0),
                                     (30, 30, 40)] * 2):
            for name, n in zip("abc", load):
                views[name].accesses += n
            arb.step(engaged)
        runs.append((arb.events, arb.summary(),
                     {n: (v.depth, v.budgets) for n, v in views.items()}))
        for e in arb.events:
            assert sum(e["budgets"].values()) <= e["budget_bytes"]
    assert runs[0] == runs[1]
    assert runs[0][1]["arbiter_rounds"] == 4
