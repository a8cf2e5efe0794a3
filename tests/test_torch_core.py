"""The port's `core` against the TPU path's: plans, access patterns, update
transactions and the embedding collection, on the CPU.

Integer results (plans, remapped indices, sampled traces) match exactly.
Pooled floats are held to the summation bound 2·eps_f32·Σ|w·x| per element
(carried through the mean's division), against the JAX collection under
`backend="xla"` on the same plans and tables. The JAX XLA route divides a
weighted mean by `cfg.pooling` and the Pallas kernel by Σw, so the
collection parity covers only where both agree; one test pins the port's
weighted mean to `ref.embedding_bag_ref`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import access_patterns as jap
from repro.core import embedding as jemb
from repro.core import hot_cache as jhot
from repro.core import update as jupdate
from repro.kernels.embedding_bag import ref as jref
from repro_torch.core import access_patterns, embedding, hot_cache, update
from repro_torch.kernels.embedding_bag import kernel, ref

TABLES, ROWS, DIM, POOL, BATCH = 4, 1000, 16, 8, 13


def _trace(seed=0, n=20_000):
    return jap.make_pattern("high_hot", ROWS, seed=seed).sample(n // 10, 10,
                                                                seed=seed)


@pytest.mark.parametrize("num_hot", [0, 1, 64, ROWS, 5 * ROWS])
def test_plan_from_trace_equals_jax(num_hot):
    trace = _trace()
    port = hot_cache.plan_from_trace(trace, ROWS, num_hot)
    want = jhot.plan_from_trace(trace, ROWS, num_hot)
    assert (port.num_rows, port.num_hot) == (want.num_rows, want.num_hot)
    np.testing.assert_array_equal(port.perm, want.perm)
    np.testing.assert_array_equal(port.inv_perm, want.inv_perm)
    assert port.pinned_bytes(DIM) == want.pinned_bytes(DIM)


def test_build_plan_ties_and_identity_equal_jax():
    counts = np.array([3, 0, 3, 7, 0, 1], np.int64)
    for k in (0, 2, 6):
        p, w = hot_cache.build_plan(counts, k), jhot.build_plan(counts, k)
        np.testing.assert_array_equal(p.perm, w.perm)
        np.testing.assert_array_equal(p.inv_perm, w.inv_perm)
    np.testing.assert_array_equal(hot_cache.identity_plan(9, 3).perm,
                                  jhot.identity_plan(9, 3).perm)
    np.testing.assert_array_equal(
        hot_cache.profile_counts(_trace(), ROWS),
        jhot.profile_counts(_trace(), ROWS))


def test_l2_budget_rows():
    # three quarters of the H100's 50 MB L2 over 512-byte f32 rows
    assert hot_cache.l2_budget_rows(128) == 37_500_000 // 512
    assert hot_cache.l2_budget_rows(128, l2_bytes=0) == 0
    assert hot_cache.l2_budget_rows(64, itemsize=2, l2_bytes=1280) == 10


@pytest.mark.parametrize("hotness", jap.HOTNESS_LEVELS)
def test_access_patterns_equal_jax(hotness):
    port = access_patterns.make_pattern(hotness, ROWS, seed=3)
    want = jap.make_pattern(hotness, ROWS, seed=3)
    assert port.alpha == want.alpha
    np.testing.assert_array_equal(port.sample(BATCH, POOL, seed=5),
                                  want.sample(BATCH, POOL, seed=5))
    idx = want.sample(64, POOL, seed=1)
    assert access_patterns.unique_access_pct(idx, ROWS) == \
        jap.unique_access_pct(idx, ROWS)
    np.testing.assert_array_equal(access_patterns.coverage_curve(idx, 10),
                                  jap.coverage_curve(idx, 10))


def test_update_txn_equals_jax():
    kw = dict(num_tables=TABLES, num_rows=ROWS, dim=2, dtype=np.float32)
    rng = np.random.default_rng(0)
    txns = (update.UpdateTxn(3, 1), jupdate.UpdateTxn(3, 1))
    chunks = [(t, rng.integers(0, ROWS, 5), rng.normal(size=(5, 2))
               .astype(np.float32)) for t in (0, 2, 0)]
    for txn in txns:
        for t, rows, vals in chunks:
            txn.add(t, rows, vals, **kw)
    port, want = txns[0].merged(), txns[1].merged()
    assert port.keys() == want.keys()
    for t in port:
        np.testing.assert_array_equal(port[t][0], want[t][0])
        np.testing.assert_array_equal(port[t][1], want[t][1])
    with pytest.raises(ValueError, match="monotonic"):
        update.UpdateTxn(1, 1)
    with pytest.raises(RuntimeError, match="begin_update"):
        update.require_open(None, "apply_update")


# ---------------------------------------------------------------------------
# EmbeddingBagCollection
# ---------------------------------------------------------------------------

def _plans():
    return [jhot.plan_from_trace(_trace(seed=t), ROWS, 64)
            for t in range(TABLES)]


def _port_plans(jplans):
    return [hot_cache.HotPlan(p.num_rows, p.num_hot, p.perm, p.inv_perm)
            for p in jplans]


def _collections(combine, pinned, pad=0):
    jcfg = jemb.EmbeddingStageConfig(
        num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL, backend="xla",
        combine=combine, pinned_rows=64 if pinned else 0,
        shard_pad_tables=pad)
    jplans = _plans() if pinned else None
    jebc = jemb.EmbeddingBagCollection(jcfg, jplans)
    params = jebc.init(jax.random.PRNGKey(0))
    cfg = embedding.EmbeddingStageConfig(
        **{f.name: getattr(jcfg, f.name)
           for f in dataclasses.fields(embedding.EmbeddingStageConfig)})
    ebc = embedding.EmbeddingBagCollection(
        cfg, _port_plans(jplans) if pinned else None, device="cpu")
    ebc.tables.copy_(torch.tensor(np.asarray(params["tables"])))
    return jebc, params, ebc


def _batch(seed=1, weighted=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ROWS, size=(BATCH, TABLES, POOL)).astype(np.int32)
    w = (rng.random((BATCH, TABLES, POOL)).astype(np.float32)
         if weighted else None)
    return idx, w


def _bound(ebc, idx, w, combine):
    """Per-table summation bound on the physical (hot-first) tables."""
    phys = ebc.remap_indices(torch.from_numpy(idx))
    return torch.stack([ref.summation_bound(
        ebc.tables[t], phys[:, t], None if w is None
        else torch.from_numpy(w[:, t]), combine)
        for t in range(TABLES)], 1).numpy()


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("combine,weighted", [("sum", False), ("sum", True),
                                              ("mean", False)])
def test_collection_matches_jax(pinned, combine, weighted):
    jebc, params, ebc = _collections(combine, pinned)
    idx, w = _batch(weighted=weighted)
    want = np.asarray(jebc.apply(params, jnp.asarray(idx),
                                 None if w is None else jnp.asarray(w)))
    with torch.inference_mode():
        port = ebc(torch.from_numpy(idx),
                   None if w is None else torch.from_numpy(w)).numpy()
    assert port.shape == (BATCH, TABLES, DIM)
    assert (np.abs(port - want) <= _bound(ebc, idx, w, combine)).all()


def test_collection_tables_and_remap_equal_jax():
    jebc, params, ebc = _collections("sum", pinned=True, pad=2)
    # the port's own init stores hot-first with the same plans
    fresh = embedding.EmbeddingBagCollection(ebc.cfg, ebc.plans,
                                             device="cpu")
    assert fresh.tables.shape == tuple(params["tables"].shape)
    raw = torch.randn((TABLES + 2, ROWS, DIM),
                      generator=torch.Generator().manual_seed(0))
    raw = raw * (1.0 / np.sqrt(DIM))
    np.testing.assert_array_equal(fresh.tables[1].numpy(),
                                  raw[1][ebc.plans[1].perm].numpy())
    idx, _ = _batch()
    np.testing.assert_array_equal(
        ebc.remap_indices(torch.from_numpy(idx)).numpy(),
        np.asarray(jebc.remap_indices(jnp.asarray(idx))))
    assert ebc.cfg.table_bytes() == jebc.cfg.table_bytes()


def test_collection_weighted_mean_follows_ref():
    """Weighted mean ÷ max(Σw, 1e-9), per `ref.embedding_bag_ref` (the TPU
    path's Pallas kernel), not ÷ pooling (its XLA route)."""
    jebc, params, ebc = _collections("mean", pinned=True)
    idx, w = _batch(seed=2, weighted=True)
    w[0, 1] = 0.0
    with torch.inference_mode():
        port = ebc(torch.from_numpy(idx), torch.from_numpy(w)).numpy()
    phys = np.asarray(jebc.remap_indices(jnp.asarray(idx)))
    tables = np.asarray(params["tables"])
    want = np.stack([np.asarray(jref.embedding_bag_ref(
        jnp.asarray(tables[t]), jnp.asarray(phys[:, t]),
        jnp.asarray(w[:, t]), mode="mean")) for t in range(TABLES)], 1)
    assert (np.abs(port - want) <= _bound(ebc, idx, w, "mean")).all()
    np.testing.assert_array_equal(port[0, 1], 0.0)


def test_collection_plain_and_auto_agree_on_cpu():
    """The tables' device alone picks the path: on the CPU the collection
    is exactly the plain gather + `_pool_rows_core` and launches nothing.
    The stage config has no option that could pick the plain version for
    tables on the card."""
    _, _, ebc = _collections("mean", pinned=True)
    assert "backend" not in {
        f.name for f in dataclasses.fields(embedding.EmbeddingStageConfig)}
    idx, w = _batch(seed=3, weighted=True)
    idx_t, w_t = torch.from_numpy(idx), torch.from_numpy(w)
    before = kernel.LAUNCHES
    with torch.inference_mode():
        a = ebc(idx_t, w_t)
        b = embedding._pool_rows_core(
            embedding.gather_rows(ebc.tables, ebc.remap_indices(idx_t)),
            w_t, "mean")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert kernel.LAUNCHES == before


def test_collection_rejects_unknown_storage_and_plan_count():
    from repro_torch.storage import UnknownBackendError
    cfg = embedding.EmbeddingStageConfig(num_tables=2, rows=8, dim=4,
                                         pooling=2, storage="pool")
    with pytest.raises(UnknownBackendError, match="device"):
        embedding.EmbeddingBagCollection(cfg, device="cpu")
    with pytest.raises(ValueError, match="plans"):
        embedding.EmbeddingBagCollection(
            dataclasses.replace(cfg, storage="device"),
            [hot_cache.identity_plan(8)], device="cpu")
