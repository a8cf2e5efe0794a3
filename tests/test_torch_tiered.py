"""The port's `tiered` backend: registry and lifecycle, the law that it
equals the port's dense path bit for bit, and serving on it end to end
against the TPU path's tiered session.

Everything runs on CPU tensors, so the port takes its plain versions
(`fused_warm_lookup_plain`, `_pool_rows_core`'s reduction). Logits agree
with the JAX session within `rtol=1e-4, atol=1e-5` (the tolerance of
tests/test_torch_dlrm.py); weighted means are compared inside the port
only, since the JAX tiered path divides them by L (ROADMAP.md Queue 3).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.embedding import EmbeddingStageConfig as JStage
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro.ps import PSConfig as JPSConfig
from repro.serving import BatcherConfig as JBatcherConfig
from repro.serving import ServingSession as JSession
from repro_torch import storage
from repro_torch.convert import load_reference_params
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.kernels.embedding_bag import fused, kernel
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import PSConfig
from repro_torch.serving import BatcherConfig, ServingSession

TABLES, ROWS, DIM, POOL, F = 3, 600, 16, 8, 5
TOL = dict(rtol=1e-4, atol=1e-5)
MLP = dict(dense_features=F, bottom_mlp=(32, DIM), top_mlp=(16, 1))


def _cfg(storage_name="tiered", combine="sum", **stage):
    stage = dict(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
                 combine=combine, storage=storage_name, **stage)
    return DLRMConfig(embedding=EmbeddingStageConfig(**stage), **MLP)


def _ps_cfg(**kw):
    base = dict(hot_rows=40, warm_slots=60, warm_backing="device",
                fused_lookup=True)
    base.update(kw)
    return base


def _trace(n=16, seed=7):
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.3, size=(n, TABLES, POOL)) - 1, ROWS - 1)
    return rng.permutation(ROWS)[ranks].astype(np.int32)


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.3, size=(n, TABLES, POOL)) - 1, ROWS - 1)
    idx = np.random.default_rng(7).permutation(ROWS)[ranks].astype(np.int32)
    return rng.normal(size=(n, F)).astype(np.float32), idx


def _twins(combine="sum", seed=0, **ps):
    """A device model and a tiered model with the same weights."""
    dev = DLRM(_cfg("device", combine), device="cpu", seed=seed)
    tier = DLRM(_cfg("tiered", combine), device="cpu", seed=seed)
    assert torch.equal(dev.ebc.tables, tier.ebc.tables)
    tier.ebc.storage.build(PSConfig(**_ps_cfg(**ps)), trace=_trace())
    return dev, tier


def test_registry_build_close_and_capabilities():
    assert storage.available() == ["device", "pool", "sharded", "tiered"]
    assert storage.resolve("tiered") is storage.TieredStorage
    model = DLRM(_cfg(), device="cpu")
    st = model.ebc.storage
    assert model.ebc.tables.device.type == "cpu"
    assert model.device.type == "cpu"
    caps = st.capabilities()
    assert not caps.device_resident and caps.refreshable
    assert not (caps.stageable or caps.tunable or caps.fused_lookup
                or caps.updatable)
    with pytest.raises(RuntimeError, match="build"):
        st.lookup(np.zeros((1, TABLES, POOL), np.int32))
    st.build(PSConfig(**_ps_cfg(async_prefetch=True)), trace=_trace())
    caps = st.capabilities()
    assert caps.stageable and caps.async_prefetch and caps.tunable
    assert caps.degradable and caps.fused_lookup and caps.updatable
    assert caps.describe().startswith("stageable+async_prefetch")
    storage.require_capability(st, "stageable", "fused_lookup")
    # the cold tier IS the collection's host tensor
    assert (st.ps.cold.tables.__array_interface__["data"][0]
            == model.ebc.tables.data_ptr())
    assert st.set_prefetch_depth(0) and st.prefetch_depth() == 0
    assert not st.capabilities().stageable
    with pytest.raises(storage.CapabilityError, match="stageable"):
        storage.require_capability(st, "stageable")
    with pytest.raises(ValueError, match="unknown capability"):
        storage.require_capability(st, "teleport")
    st.close()
    st.close()
    assert not st.capabilities().tunable and st.stats() == {}
    with pytest.raises(RuntimeError, match="closed"):
        st.stage(np.zeros((1, TABLES, POOL), np.int32))
    st.build(PSConfig(**_ps_cfg()), trace=_trace())     # re-opens
    assert st.capabilities().fused_lookup
    st.close()


def test_build_options_and_guards():
    model = DLRM(_cfg(), device="cpu")
    st = model.ebc.storage
    with pytest.raises(ValueError, match="trace="):
        st.build()
    with pytest.raises(ValueError, match="only apply"):
        st.build(PSConfig(), device_budget_bytes=10)
    budget = TABLES * DIM * 4 * 80
    st.build(trace=_trace(), device_budget_bytes=budget,
             warm_backing="device", fused_lookup=True)
    assert st.ps.cfg.hot_rows + st.ps.cfg.warm_slots == 80
    assert st.retune_capacities(budget) is None       # empty window
    st.lookup(_trace(4, seed=1))
    assert st.retune_capacities(budget)["budget_bytes"] == budget
    st.close()
    with pytest.raises(ValueError, match="pinned_rows"):
        DLRM(_cfg(pinned_rows=5), device="cpu")
    with pytest.raises(ValueError, match="tables"):
        DLRM(_cfg(), device="cpu", tables=torch.zeros(2, ROWS, DIM))


@pytest.mark.parametrize("combine,weighted", [("sum", False), ("sum", True),
                                              ("mean", False),
                                              ("mean", True)])
@pytest.mark.parametrize("fused_on", [True, False])
def test_tiered_equals_device_bit_for_bit(combine, weighted, fused_on):
    """Every storage backend equals the port's dense path: hot set on,
    warm hits, a refresh, a committed online update, and a padded batch."""
    dev, tier = _twins(combine, fused_lookup=fused_on)
    st = tier.ebc.storage
    assert st.capabilities().fused_lookup == fused_on
    rng = np.random.default_rng(3)
    batches = [_queries(13, seed)[1] for seed in range(4)]
    weights = [rng.random(b.shape).astype(np.float32) if weighted else None
               for b in batches]

    def same(i):
        w = weights[i]
        with torch.no_grad():
            a = dev.ebc(torch.from_numpy(batches[i]),
                        None if w is None else torch.from_numpy(w))
            b = tier.ebc(batches[i], w)
        np.testing.assert_array_equal(b.numpy(), a.numpy())

    same(0)
    same(0)                                        # now warm
    assert st.stats()["warm_hits"] > 0 and st.stats()["hot_hits"] > 0
    assert st.refresh()["replanned"]
    same(1)
    rows = np.unique(batches[2][:, 1].ravel())[:12]
    vals = rng.normal(size=(rows.size, DIM)).astype(np.float32)
    for s in (dev.ebc.storage, st):
        assert s.begin_update(1)
        s.apply_update(1, rows, vals)
        assert s.commit_update(1)["updated"]
    same(2)
    st.hint_valid(5)                               # 8 padding queries
    same(3)
    assert st.version() == 1
    st.close()


def test_launch_counters_stay_at_zero_on_the_cpu():
    _, tier = _twins()
    before = fused.LAUNCHES, kernel.LAUNCHES
    tier.ebc(_trace(3, seed=2))
    assert (fused.LAUNCHES, kernel.LAUNCHES) == before
    tier.ebc.storage.close()


def _jax_tiered(combine, ps, seed=0):
    stage = dict(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
                 combine=combine)
    jmodel = JDLRM(JConfig(embedding=JStage(**stage, backend="xla",
                                            storage="tiered"), **MLP))
    params = jmodel.init(jax.random.PRNGKey(seed))
    jmodel.ebc.storage.build(params, JPSConfig(**ps), trace=_trace())
    model = DLRM(_cfg("tiered", combine), device="cpu")
    load_reference_params(model, jax.tree_util.tree_map(np.asarray, params))
    model.ebc.storage.build(PSConfig(**ps), trace=_trace())
    return jmodel, params, model


def _tap(sess):
    got = {}
    sess.server.on_batch = lambda batch, scores: got.update(
        {q.qid: float(s) for q, s in zip(batch, scores)})
    return got


@pytest.mark.parametrize("combine,ps", [
    ("sum", _ps_cfg(async_prefetch=True)),
    ("mean", _ps_cfg(eviction="lru")),
    ("sum", _ps_cfg(fused_lookup=False, warm_backing="host")),
])
def test_session_matches_jax_tiered_session(combine, ps):
    """The split engine on both packages: the same qids scored within the
    tolerance, and the same staging and cache counters with the refresh
    driver re-pinning every 2 batches (synchronously: an async plan lands
    whenever its thread finishes, so its batch is timing-dependent)."""
    jmodel, params, model = _jax_tiered(combine, ps)
    cfg = dict(max_batch=8, max_wait_s=0.0)
    dense, idx = _queries(37, seed=1)          # 4 full batches + 5 padded
    kw = dict(refresh_every_batches=2)
    with JSession(jmodel, params, batcher=JBatcherConfig(**cfg), **kw) as js, \
            ServingSession(model, batcher=BatcherConfig(**cfg), **kw) as ps_:
        want, got = _tap(js), _tap(ps_)
        for sess in (js, ps_):
            assert sess.submit_batch(dense, idx) == 37
            sess.drain()
        assert sorted(got) == sorted(want) == list(range(37))
        torch.testing.assert_close(torch.tensor([got[q] for q in range(37)]),
                                   torch.tensor([want[q] for q in range(37)]),
                                   **TOL)
        jp, pp = js.percentiles(), ps_.percentiles()
        for k in ("served", "hot_hits", "warm_hits", "cold_misses",
                  "evictions", "prefetch_hits", "max_queue_depth",
                  "degraded_rows"):
            assert pp[k] == jp[k], k
        assert pp["refreshes"] == jp["refreshes"] == 2
        assert pp["staged_rows"] > 0 and pp["prefetch_hits"] > 0
        assert len(ps_.stats.batch_latencies_s) == 5
    assert model.ebc.storage.ps is None


def test_async_refresh_plans_on_a_helper_thread():
    """`async_refresh=True`: the plan runs on a helper thread and lands at
    a later poll (or at close()); scores still match the JAX session, and
    the tier counters still add up."""
    jmodel, params, model = _jax_tiered("sum", _ps_cfg(async_prefetch=True))
    cfg = dict(max_batch=8, max_wait_s=0.0)
    dense, idx = _queries(37, seed=2)
    kw = dict(refresh_every_batches=1, async_refresh=True)
    with JSession(jmodel, params, batcher=JBatcherConfig(**cfg), **kw) as js, \
            ServingSession(model, batcher=BatcherConfig(**cfg), **kw) as ps_:
        want, got = _tap(js), _tap(ps_)
        for sess in (js, ps_):
            sess.submit_batch(dense, idx)
            sess.drain()
        torch.testing.assert_close(torch.tensor([got[q] for q in range(37)]),
                                   torch.tensor([want[q] for q in range(37)]),
                                   **TOL)
        st = ps_.storage.stats()
        assert st["hot_hits"] + st["warm_hits"] + st["cold_misses"] == \
            st["total_accesses"] == 37 * TABLES * POOL
        assert ps_.server._refresh_pool is not None
    # close() installed the last in-flight plan and joined the helper
    assert ps_.stats.async_refreshes >= 1
    assert ps_.server._refresh_pool is None


def test_split_engine_serves_host_backed_backends():
    """A host-backed backend gets the split engine: the collection's
    lookup feeds `forward_from_pooled`, and the logits equal the device
    model's on the same weights."""
    dev, tier = _twins()
    cfg = dict(max_batch=8, max_wait_s=0.0)
    dense, idx = _queries(16, seed=4)
    out = []
    for model in (dev, tier):
        with ServingSession(model, batcher=BatcherConfig(**cfg)) as sess:
            got = _tap(sess)
            sess.submit_batch(dense, idx)
            sess.drain()
            out.append(got)
    assert out[0] == out[1]
    with pytest.raises(storage.CapabilityError, match="refreshable"):
        ServingSession(dev, refresh_every_batches=2, warmup=False)


def test_warmup_leaves_no_trace_in_the_tiers():
    _, tier = _twins(async_prefetch=True)
    with ServingSession(tier, batcher=BatcherConfig(max_batch=8)) as sess:
        st = sess.storage.stats()
        assert st["total_accesses"] == 0 and st["warm_occupancy"] == 0
        assert len(sess.storage.ps.window) == 0
        dense, idx = _queries(3, seed=5)
        sess.submit_batch(dense, idx)
        sess.drain()
        # 3 real queries of a batch padded to 8
        assert sess.percentiles()["total_accesses"] == 3 * TABLES * POOL


def test_tiered_stage_config_needs_no_device_tables():
    cfg = dataclasses.replace(_cfg().embedding, num_tables=2)
    tables = torch.randn(2, ROWS, DIM)
    from repro_torch.core.embedding import EmbeddingBagCollection
    ebc = EmbeddingBagCollection(cfg, device="cpu", tables=tables)
    assert ebc.tables.data_ptr() == tables.data_ptr()
    assert ebc.device.type == "cpu"
