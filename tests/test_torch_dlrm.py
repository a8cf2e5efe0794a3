"""The port's DLRM against the TPU path's on weights carried across.

`repro.models.dlrm.DLRM.init(PRNGKey(seed))` makes the weights,
`repro_torch.convert.load_reference_params` loads them, and the same numpy
batch goes through both forwards on the CPU. Logits are compared with
`torch.testing.assert_close(rtol=1e-4, atol=1e-5)`; the largest difference
measured on these inputs was 2.7e-7 on logits up to 0.47 (float32, CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hot_cache as jhot
from repro.core.embedding import EmbeddingStageConfig as JStage
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro_torch.convert import dlrm_state_dict_from_numpy, load_reference_params
from repro_torch.core import hot_cache
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.models import DLRM, DLRMConfig

TABLES, ROWS, DIM, POOL, BATCH = 4, 1000, 16, 8, 13


def _configs(combine="sum", pinned=0, interaction="dot"):
    stage = dict(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
                 combine=combine, pinned_rows=pinned)
    mlp = dict(dense_features=5, bottom_mlp=(32, DIM), top_mlp=(32, 16, 1),
               interaction=interaction)
    return (JConfig(embedding=JStage(**stage, backend="xla"), **mlp),
            DLRMConfig(embedding=EmbeddingStageConfig(**stage), **mlp))


def _pair(combine="sum", pinned=0, interaction="dot", seed=0):
    jcfg, cfg = _configs(combine, pinned, interaction)
    jplans = plans = None
    if pinned:
        trace = np.random.default_rng(seed).zipf(1.2, 8000) % ROWS
        jplans = [jhot.plan_from_trace(trace, ROWS, pinned)] * TABLES
        plans = [hot_cache.HotPlan(p.num_rows, p.num_hot, p.perm, p.inv_perm)
                 for p in jplans]
    jmodel = JDLRM(jcfg, jplans)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = DLRM(cfg, plans, device="cpu", seed=seed)
    load_reference_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, model


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(BATCH, 5)).astype(np.float32)
    idx = rng.integers(0, ROWS, size=(BATCH, TABLES, POOL)).astype(np.int32)
    return dense, idx


@pytest.mark.parametrize("combine,pinned,interaction", [
    ("sum", 0, "dot"), ("mean", 0, "dot"), ("sum", 64, "dot"),
    ("mean", 64, "cat")])
def test_forward_matches_jax(combine, pinned, interaction):
    jmodel, params, model = _pair(combine, pinned, interaction)
    dense, idx = _batch()
    want = np.asarray(jmodel.forward(params, jnp.asarray(dense),
                                     jnp.asarray(idx)))
    with torch.inference_mode():
        got = model(torch.from_numpy(dense), torch.from_numpy(idx))
    assert got.shape == (BATCH,)
    torch.testing.assert_close(got, torch.tensor(want), rtol=1e-4,
                               atol=1e-5)


def test_forward_from_pooled_and_embedding_only_match_jax():
    jmodel, params, model = _pair(seed=3)
    dense, idx = _batch(seed=4)
    pooled = np.asarray(jmodel.embedding_only(params, jnp.asarray(idx)))
    with torch.inference_mode():
        port_pooled = model.embedding_only(torch.from_numpy(idx))
        got = model.forward_from_pooled(torch.from_numpy(dense),
                                        torch.tensor(pooled))
    torch.testing.assert_close(port_pooled, torch.tensor(pooled),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jmodel.forward_from_pooled(
        params, jnp.asarray(dense), jnp.asarray(pooled)))
    torch.testing.assert_close(got, torch.tensor(want), rtol=1e-4,
                               atol=1e-5)


def test_interaction_pairs_in_jax_order():
    """`torch.triu_indices(t, t, 1)` lists pairs in `jnp.triu_indices(t,
    k=1)`'s row-major order, so the top MLP's rows line up."""
    jmodel, params, model = _pair()
    rng = np.random.default_rng(5)
    bottom = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    pooled = rng.normal(size=(BATCH, TABLES, DIM)).astype(np.float32)
    want = np.asarray(jmodel._interact(jnp.asarray(bottom),
                                       jnp.asarray(pooled)))
    got = model._interact(torch.from_numpy(bottom), torch.tensor(pooled))
    assert got.shape == (BATCH, model.cfg.interaction_dim())
    torch.testing.assert_close(got, torch.tensor(want), rtol=1e-5,
                               atol=1e-5)


def test_state_dict_names_and_layout():
    jmodel, params, model = _pair()
    sd = dlrm_state_dict_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           params))
    assert set(sd) == set(model.state_dict())
    # weights keep the [in, out] layout of the TPU path
    assert tuple(sd["bottom.w0"].shape) == (5, 32)
    assert tuple(model.top.w0.shape) == (model.cfg.interaction_dim(), 32)
    assert model.cfg.interaction_dim() == jmodel.cfg.interaction_dim()


def test_random_init_is_seeded_and_finite():
    _, cfg = _configs()
    a, b = DLRM(cfg, device="cpu", seed=7), DLRM(cfg, device="cpu", seed=7)
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
        assert torch.isfinite(x).all(), name
    # truncated normal: fan-in scaled, cut at two standard deviations
    w = a.bottom.w0
    assert w.abs().max() <= 2.0 / np.sqrt(5) + 1e-6
    assert not torch.equal(
        DLRM(cfg, device="cpu", seed=8).ebc.tables, a.ebc.tables)


def test_mismatched_bottom_mlp_rejected():
    _, cfg = _configs()
    with pytest.raises(ValueError, match="bottom MLP"):
        DLRM(dataclasses.replace(cfg, bottom_mlp=(32, DIM + 1)), device="cpu")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="cuda"):
        DLRM(cfg)
