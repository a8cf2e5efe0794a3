"""The port's serving stack against the TPU path's, end to end on the CPU.

Both `ServingSession`s serve the same numpy queries over the `device`
backend on the same weights (JAX under `backend="xla"`, the port on CPU
tensors, so its plain path). The same qids are served, and scores agree
within `rtol=1e-4, atol=1e-5`. A `device` online update committed between
batches is visible on the next batch and equals the JAX backend after the
same update.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.embedding import EmbeddingStageConfig as JStage
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro.serving import BatcherConfig as JBatcherConfig
from repro.serving import Batcher as JBatcher
from repro.serving import Query as JQuery
from repro.serving import QueryShedError as JShed
from repro.serving import ServingSession as JSession
from repro_torch import storage
from repro_torch.convert import load_reference_params
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.serving import (Batcher, BatcherConfig, Query,
                                 QueryShedError, ServingSession)

TABLES, ROWS, DIM, POOL, F = 3, 1000, 16, 8, 5
TOL = dict(rtol=1e-4, atol=1e-5)


def _models(seed=0):
    stage = dict(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL)
    mlp = dict(dense_features=F, bottom_mlp=(32, DIM), top_mlp=(16, 1))
    jmodel = JDLRM(JConfig(embedding=JStage(**stage, backend="xla"), **mlp))
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = DLRM(DLRMConfig(embedding=EmbeddingStageConfig(**stage), **mlp),
                 device="cpu")
    load_reference_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, model


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, F)).astype(np.float32),
            rng.integers(0, ROWS, size=(n, TABLES, POOL)).astype(np.int32))


def _tap(sess):
    got = {}
    sess.server.on_batch = lambda batch, scores: got.update(
        {q.qid: float(s) for q, s in zip(batch, scores)})
    return got


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    qids = sorted(want)
    torch.testing.assert_close(torch.tensor([got[q] for q in qids]),
                               torch.tensor([want[q] for q in qids]), **TOL)


def test_session_serves_same_queries_as_jax():
    jmodel, params, model = _models()
    cfg = dict(max_batch=8, max_wait_s=0.0)
    dense, idx = _queries(21, seed=1)           # 8 + 8 + a padded 5
    with JSession(jmodel, params, batcher=JBatcherConfig(**cfg)) as js, \
            ServingSession(model, batcher=BatcherConfig(**cfg)) as ps:
        want, got = _tap(js), _tap(ps)
        for sess in (js, ps):
            assert sess.submit_batch(dense, idx) == 21
            sess.drain()
        _assert_same(got, want)
        assert ps.stats.served == js.stats.served == 21
        assert len(ps.stats.batch_latencies_s) == 3
        pct = ps.percentiles()
        assert pct["served"] == 21 and pct["shed_queries"] == 0
        assert set(pct) == set(js.percentiles())


def test_device_update_visible_on_next_batch_and_equals_jax():
    jmodel, params, model = _models(seed=2)
    jmodel.ebc.storage.build(params)
    cfg = dict(max_batch=4, max_wait_s=0.0)
    dense, idx = _queries(4, seed=3)
    rng = np.random.default_rng(4)
    rows = np.unique(idx[:, 1].ravel())[:6]
    vals = rng.normal(size=(rows.size, DIM)).astype(np.float32)
    with JSession(jmodel, params, batcher=JBatcherConfig(**cfg)) as js, \
            ServingSession(model, batcher=BatcherConfig(**cfg)) as ps:
        want, got = _tap(js), _tap(ps)
        for sess in (js, ps):
            sess.submit_batch(dense, idx, qid0=0)
            sess.drain()
        st = ps.storage
        assert st.capabilities().updatable and st.version() == 0
        for s in (js.storage, st):
            assert s.begin_update(1)
            s.apply_update(1, rows, vals)
        # applied but not committed: invisible
        for sess in (js, ps):
            sess.submit_batch(dense, idx, qid0=100)
            sess.drain()
        for s in (js.storage, st):
            res = s.commit_update(1)
            assert res["updated"] and res["rows"] == rows.size
        for sess in (js, ps):
            sess.submit_batch(dense, idx, qid0=200)
            sess.drain()
        _assert_same(got, want)
        assert st.version() == 1
        assert [got[q] for q in range(4)] == [got[100 + q] for q in range(4)]
        assert any(abs(got[q] - got[200 + q]) > 1e-6 for q in range(4))
        np.testing.assert_array_equal(model.ebc.tables[1, rows].numpy(), vals)


def test_device_update_through_hot_first_remap():
    """With pinning the stored tables are permuted; logical rows route
    through the collection's remap."""
    stage = EmbeddingStageConfig(num_tables=2, rows=50, dim=4, pooling=3,
                                 pinned_rows=5)
    from repro_torch.core import hot_cache
    plans = [hot_cache.plan_from_trace(
        np.random.default_rng(t).integers(0, 50, 200), 50, 5)
        for t in range(2)]
    model = DLRM(DLRMConfig(dense_features=2, bottom_mlp=(4,),
                            top_mlp=(1,), embedding=stage), plans,
                 device="cpu")
    st = model.ebc.storage
    vals = np.full((2, 4), 7.0, np.float32)
    st.begin_update(3)
    st.apply_update(1, np.array([0, 49]), vals)
    st.commit_update(3)
    phys = plans[1].inv_perm[[0, 49]]
    np.testing.assert_array_equal(model.ebc.tables[1, phys].numpy(), vals)
    with pytest.raises(ValueError, match="monotonic"):
        st.begin_update(2)
    assert st.begin_update(4) and st.abort_update(4)
    with pytest.raises(RuntimeError, match="begin_update"):
        st.commit_update(4)


@pytest.mark.parametrize("kwarg", [
    pytest.param("auto_tune", id="auto_tune-item 9"),
    pytest.param("slo", id="slo-item 8"),
    pytest.param("controllers", id="controllers-item 7")])
def test_unported_session_options_raise(kwarg):
    """The controller options are ported (ROADMAP.md Queue 1 items 7-9);
    what both packages still refuse is refused alike: a per-controller
    kwarg together with `controllers=`, and an arbiter on a single
    session (it arbitrates across tenants)."""
    jmodel, params, model = _models()
    from repro.ps.tuning import ArbiterConfig as JArbiter
    from repro.serving import SLOConfig as JSLO
    from repro.serving import configure as jconfigure
    from repro_torch.ps.tuning import ArbiterConfig
    from repro_torch.serving import SLOConfig, configure
    if kwarg == "controllers":
        cases = ((ServingSession, model, {"controllers": configure(
                     arbiter=ArbiterConfig())}, "arbitrate"),
                 (JSession, jmodel, {"controllers": jconfigure(
                     arbiter=JArbiter())}, "arbitrate"))
    else:
        value = {"auto_tune": (True, True),
                 "slo": (SLOConfig(10.0), JSLO(10.0))}[kwarg]
        cases = ((ServingSession, model, {kwarg: value[0],
                  "controllers": configure()}, "both"),
                 (JSession, jmodel, {kwarg: value[1],
                  "controllers": jconfigure()}, "both"))
    for cls, m, kw, match in cases:
        args = (m,) if cls is ServingSession else (m, params)
        with pytest.raises(ValueError, match=match):
            cls(*args, warmup=False, **kw)


def test_controllers_ride_in_percentiles_like_jax():
    """`auto_tune=` and `slo=` are aliases of `controllers=`; either way
    the controllers' summaries carry the same keys as the JAX session's
    on `device` (the tuner inert, the SLO controller live)."""
    from repro.serving import SLOConfig as JSLO
    from repro.serving import configure as jconfigure
    from repro_torch.serving import SLOConfig, configure
    jmodel, params, model = _models()
    cfg = dict(max_batch=8, max_wait_s=0.0)
    dense, idx = _queries(16, seed=6)
    keys = []
    for sess in (JSession(jmodel, params, batcher=JBatcherConfig(**cfg),
                          controllers=jconfigure(auto_tune=True,
                                                 slo=JSLO(50.0))),
                 ServingSession(model, batcher=BatcherConfig(**cfg),
                                controllers=configure(auto_tune=True,
                                                      slo=SLOConfig(50.0))),
                 ServingSession(model, batcher=BatcherConfig(**cfg),
                                auto_tune=True, slo=SLOConfig(50.0))):
        with sess:
            assert sess.tuner is not None and not sess.tuner.enabled
            assert sess.server.batcher.cfg.deadline_ms == 50.0
            sess.submit_batch(dense, idx)
            sess.drain()
            keys.append(set(sess.percentiles()))
    assert keys[0] == keys[1] == keys[2]
    assert {"slo_level", "slo_breaches"} <= keys[1]


def test_warmup_runs_every_shrink_rung():
    """With a shrink rung armed, warmup runs the engine at every batch
    size the ladder can pick, then leaves no trace in the counters."""
    from repro_torch.serving import SLOConfig
    _, _, model = _models()
    sizes = []
    forward = model.forward
    model.forward = lambda d, i, w=None: (sizes.append(len(d)),
                                          forward(d, i, w))[1]
    ServingSession(model, batcher=BatcherConfig(max_batch=64),
                   slo=SLOConfig(10.0, min_batch=12)).close()
    assert sizes == [64, 32, 16, 12]


def test_drain_on_a_virtual_clock_jumps_to_the_deadline():
    """A partial batch inside its window: drain advances the virtual
    clock to the head's deadline instead of spinning, and the latency is
    the window plus the real service time."""
    from repro_torch.traffic import VirtualClock
    _, _, model = _models()
    clock = VirtualClock()
    with ServingSession(model, batcher=BatcherConfig(max_batch=8,
                                                     max_wait_s=0.5),
                        clock=clock) as sess:
        dense, idx = _queries(3, seed=7)
        sess.submit_batch(dense, idx)
        assert [q.arrival_s for q in sess.server.batcher.queue] == [0.0] * 3
        sess.drain()
        (service,) = sess.stats.batch_latencies_s
        assert clock() == pytest.approx(0.5 + service)
        assert sess.stats.query_latencies_s == [clock()] * 3


def test_host_backed_backend_raises():
    """A backend whose capabilities say host-backed gets the split engine:
    the session serves it through `ebc(...)` then `forward_from_pooled`,
    and the scores equal the device engine's on the same weights."""
    calls = []

    @storage.register("host_probe")
    class HostProbe(storage.DeviceStorage):
        def capabilities(self):
            return storage.StorageCapabilities(device_resident=False)

        def lookup(self, indices, weights=None, *, pre_remapped=False):
            calls.append(type(indices))
            return super().lookup(torch.as_tensor(indices), weights,
                                  pre_remapped=pre_remapped)
    try:
        stage = dict(num_tables=2, rows=10, dim=DIM, pooling=2)
        mlp = dict(dense_features=F, bottom_mlp=(DIM,), top_mlp=(1,))
        models = [DLRM(DLRMConfig(embedding=EmbeddingStageConfig(
            **stage, storage=name), **mlp), device="cpu")
            for name in ("device", "host_probe")]
        assert models[1].ebc.tables.device.type == "cpu"
        dense = np.random.default_rng(0).normal(size=(3, F)).astype(
            np.float32)
        idx = np.random.default_rng(1).integers(0, 10, (3, 2, 2)).astype(
            np.int32)
        got = []
        for model in models:
            with ServingSession(model, batcher=BatcherConfig(
                    max_batch=4, max_wait_s=0.0)) as sess:
                got.append(_tap(sess))
                sess.submit_batch(dense, idx)
                sess.drain()
        assert got[0] == got[1] and len(got[1]) == 3
        # the host lookup takes the batch's numpy indices as they are
        assert calls and all(c is np.ndarray for c in calls)
    finally:
        storage.unregister("host_probe")


def test_registry_misuse_is_loud():
    assert storage.available() == ["device", "pool", "sharded", "tiered"]
    with pytest.raises(ValueError, match="already registered"):
        storage.register("device")(storage.DeviceStorage)
    with pytest.raises(TypeError, match="not an EmbeddingStorage"):
        storage.register("not_storage")(object)
    assert "not_storage" not in storage.available()
    with pytest.raises(storage.UnknownBackendError, match="sharded"):
        storage.resolve("nope")
    assert storage.resolve("pool") is storage.PoolStorage


def test_backend_stats_mirror_into_percentiles():
    """The loop mirrors the bound backend's `stats()` after every batch;
    `device` reports none, so its percentiles carry only latency and
    admission keys."""
    @storage.register("stats_probe")
    class StatsProbe(storage.DeviceStorage):
        def stats(self):
            return {"probe_version": self.version()}
    try:
        cfg = DLRMConfig(dense_features=F, bottom_mlp=(DIM,), top_mlp=(1,),
                         embedding=EmbeddingStageConfig(
                             num_tables=2, rows=10, dim=DIM, pooling=2,
                             storage="stats_probe"))
        dense = np.zeros((3, F), np.float32)
        idx = np.zeros((3, 2, 2), np.int32)
        with ServingSession(DLRM(cfg, device="cpu"),
                            batcher=BatcherConfig(max_batch=4)) as sess:
            sess.submit_batch(dense, idx)
            sess.drain()
            assert sess.percentiles()["probe_version"] == 0
    finally:
        storage.unregister("stats_probe")
    _, _, model = _models()
    with ServingSession(model, batcher=BatcherConfig(max_batch=4)) as sess:
        sess.submit_batch(dense[:, :F], np.zeros((3, TABLES, POOL), np.int32))
        sess.drain()
        assert set(sess.percentiles()) == {
            "p50_ms", "p95_ms", "p99_ms", "mean_batch_ms", "served",
            "shed_queries", "request_queue_len"}


def test_batcher_admission_matches_jax():
    """The port's batcher is a copy of the reference's: the same arrivals
    give the same sheds, reasons and batches."""
    times = iter(np.arange(0, 100, 0.001))
    clock = lambda: next(times)                       # noqa: E731
    outcomes = []
    for mod, cfg_cls, query, shed in (
            (Batcher, BatcherConfig, Query, QueryShedError),
            (JBatcher, JBatcherConfig, JQuery, JShed)):
        times = iter(np.arange(0, 100, 0.001))
        b = mod(cfg_cls(max_batch=3, max_wait_s=0.01, max_queue=5,
                        deadline_ms=2.5), clock=clock)
        log = []
        for qid in range(12):
            if qid == 7:
                b.observe_service(0.002)
            try:
                b.submit(query(qid=qid, dense=np.zeros(1),
                               indices=np.zeros((1, 1))))
                log.append(("ok", qid))
            except shed as e:
                log.append((e.reason, qid))
            if qid % 4 == 3:
                batch = b.next_batch(force=qid == 11)
                log.append([q.qid for q in batch] if batch else None)
        outcomes.append((log, b.shed, dict(b.shed_reasons)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] > 0


@pytest.mark.parametrize("argv", [
    "--storage device --hotness med_hot",
    "--storage tiered --hotness high_hot --update-every 1 --auto-tune",
    "--storage tiered --trace flash --slo-p99-ms 5 --min-batch 4",
])
def test_serve_dlrm_example_on_the_cpu(argv, capsys):
    from repro_torch.examples import serve_dlrm
    serve_dlrm.main(("--device cpu --tables 2 --rows 400 --pooling 4 "
                     "--queries 48 --batch 8 --hot-rows 40 --warm-slots 40 "
                     + argv).split())
    out = capsys.readouterr().out
    assert ("submitted=48" in out if "--trace" in argv
            else "served=  48" in out)
    if "--update-every" in argv:
        assert " v=" in out and "updates=" in out


@pytest.mark.parametrize("argv", [
    "--storage sharded --shards 2 --hotness med_hot",
    "--storage sharded --shards 3 --placement balanced --migrate-every 2 "
    "--hotness high_hot",
    "--tenants 2 --shards 2",
])
def test_serve_dlrm_example_sharded_and_tenants_on_the_cpu(argv, capsys):
    """`--storage sharded` and `--tenants N` serve 48 queries on the CPU."""
    from repro_torch.examples import serve_dlrm
    serve_dlrm.main(("--device cpu --tables 2 --rows 400 --pooling 4 "
                     "--queries 48 --batch 8 --hot-rows 40 --warm-slots 40 "
                     + argv).split())
    out = capsys.readouterr().out
    if "--tenants" in argv:
        assert "t0: submitted=24 served=24" in out
        assert "t1: submitted=24 served=24" in out
        assert "shared: served=48 tenants=2" in out
    else:
        assert "served=  48" in out and "placement=" in out


@pytest.mark.parametrize("argv", ["--storage pool --workers 2",
                                  "--storage pool --tenants 2 --workers 2"])
def test_serve_dlrm_example_names_what_is_not_ported(argv, capsys):
    """The two cases that once named the unported pool (ROADMAP.md Queue 1
    item 10) now serve on it: `--storage pool --workers 2` and tenants on
    the pool, 48 queries on the CPU, ending with the workers' liveness
    line."""
    from repro_torch.examples import serve_dlrm
    serve_dlrm.main(("--device cpu --tables 2 --rows 400 --pooling 4 "
                     "--queries 48 --batch 8 --hot-rows 40 --warm-slots 40 "
                     "--hotness med_hot " + argv).split())
    out = capsys.readouterr().out
    assert "pool workers 2/2 alive" in out
    if "--tenants" in argv:
        assert "tenants=2 backend=pool" in out
        assert "shared: served=48 tenants=2" in out
    else:
        assert "served=  48" in out and "placement=" in out
