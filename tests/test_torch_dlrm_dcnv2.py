"""MLPerf's DLRM-DCNv2 in the port, on the CPU at a small size: tables of
different sizes with a bag length each (`RaggedStageConfig`)
and the low-rank cross network (`DLRMConfig.interaction = "dcn"`), against
the plain reference `tests/_reference_dlrm_dcnv2.py` on seeded weights.

On the CPU the ragged lookup is the plain gather, one table at a time; the
CUDA kernel (`csrc/ragged_bag.cu`) is held to it on the card by
`chip_smoke.py`'s `ragged` phase and by the benchmark's
`dlrm-dcnv2.med_hot` cell."""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import _reference_dlrm_dcnv2 as reference
from repro_torch import tracing
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.embedding import (EmbeddingBagCollection,
                                        EmbeddingStageConfig,
                                        RaggedStageConfig)
from repro_torch.kernels.embedding_bag import (RaggedLayout,
                                               embedding_bag_ragged_cuda)
from repro_torch.launch.steps import make_dlrm_serve_step
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.models.layers import LowRankCrossNet
from repro_torch.serving import ServingSession, UpdateConfig, configure

ROWS = (3, 10, 40, 1000, 7)
BAGS = (1, 3, 2, 12, 1)
DIM, DENSE, BATCH = 16, 5, 11

# Tolerances, as a gap over the largest reference entry. The CPU path
# pools exactly as the reference does (rows widened to f32, summed in
# lookup order), so the bags may differ only by the order of an f32 sum
# of at most 12 rows: 1e-6. The logits pass the bags through 2 cross
# layers and 4 products of at most 96 terms, in cuBLAS-free f32 on both
# sides but with the bias and the cross term fused (`addmm`, `addcmul`)
# on the program's: a few f32 roundings, 1e-5. Rounding the pooled bags
# to bf16 moves them by up to 2**-9 of their size, 2e-3: the control
# below must break both.
POOLED_TOL = 1e-6
LOGIT_TOL = 1e-5


def small_config(dtype="float32", interaction="dcn", **stage):
    emb = dict(dim=DIM, dtype=dtype, table_rows=ROWS, table_pooling=BAGS)
    emb.update(stage)
    return DLRMConfig(dense_features=DENSE, bottom_mlp=(32, DIM),
                      top_mlp=(32, 16, 1), interaction=interaction,
                      dcn_layers=2, dcn_rank=8,
                      embedding=RaggedStageConfig(**emb))


def ragged_indices(rows, bags, batch=BATCH, seed=0) -> torch.Tensor:
    """[B, sum(bags)] int32: table t's ids in [0, rows[t]) at its own
    columns."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, r, size=(batch, l)) for r, l in zip(rows, bags)]
    return torch.from_numpy(np.concatenate(cols, axis=1).astype(np.int32))


def dense_inputs(batch=BATCH, seed=1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((batch, DENSE)).astype(np.float32))


def layers_of(model):
    def tower(t):
        return [(getattr(t, f"w{i}").detach(), getattr(t, f"b{i}").detach())
                for i in range(t.num_layers)]
    cross = [(getattr(model.cross, f"v{i}").detach(),
              getattr(model.cross, f"w{i}").detach(),
              getattr(model.cross, f"b{i}").detach())
             for i in range(model.cross.num_layers)]
    return tower(model.bottom), cross, tower(model.top)


def gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def with_cross_bias(model, seed=2):
    """Give the cross network nonzero biases (TorchRec starts them at
    zero), so that the comparison sees them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for i in range(model.cross.num_layers):
            getattr(model.cross, f"b{i}").normal_(0.0, 0.05, generator=gen)
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_bags_match_the_reference(dtype):
    cfg = small_config(dtype)
    model = with_cross_bias(DLRM(cfg, device="cpu", seed=7))
    idx, dense = ragged_indices(ROWS, BAGS), dense_inputs()
    with torch.inference_mode():
        bags = model.ebc(idx)
        got = model(dense, idx)
    assert bags.dtype == torch.float32 and bags.shape == (BATCH, 5, DIM)
    bottom, cross, top = layers_of(model)
    ref_bags = reference.pooled(model.ebc.tables, ROWS, BAGS, idx)
    ref = reference.logits(bottom, cross, top, dense, ref_bags)
    assert gap(bags, ref_bags) <= POOLED_TOL
    assert gap(got, ref) <= LOGIT_TOL
    assert got.shape == (BATCH,) and torch.isfinite(got).all()
    # the control, a precision step below, breaks both tolerances
    ctl_bags = reference.pooled(model.ebc.tables, ROWS, BAGS, idx,
                                lower=True)
    ctl = reference.logits(bottom, cross, top, dense, ctl_bags, lower=True)
    assert gap(ctl_bags, ref_bags) > POOLED_TOL
    assert gap(ctl, ref) > LOGIT_TOL


@pytest.mark.parametrize("interaction", ["dot", "cat", "dcn"])
def test_equal_ragged_tables_are_the_stacked_path_bit_for_bit(interaction):
    """Ragged tables with equal rows and bag sizes hold the stacked tables
    flat, and give the stacked path's bags and logits bit for bit."""
    tables_n, rows, pool = 4, 50, 3
    stacked_cfg = DLRMConfig(
        dense_features=DENSE, bottom_mlp=(32, DIM), top_mlp=(32, 16, 1),
        interaction=interaction, dcn_layers=2, dcn_rank=8,
        embedding=EmbeddingStageConfig(num_tables=tables_n, rows=rows,
                                       dim=DIM, pooling=pool))
    ragged_cfg = dataclasses.replace(stacked_cfg, embedding=RaggedStageConfig(
        dim=DIM, table_rows=(rows,) * tables_n,
        table_pooling=(pool,) * tables_n))
    tables = torch.randn((tables_n, rows, DIM),
                         generator=torch.Generator().manual_seed(4))
    stacked = DLRM(stacked_cfg, device="cpu", seed=5, tables=tables)
    ragged = DLRM(ragged_cfg, device="cpu", seed=5,
                  tables=tables.reshape(tables_n * rows, DIM))
    idx = torch.randint(0, rows, (BATCH, tables_n, pool), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(6))
    dense = dense_inputs()
    with torch.inference_mode():
        assert torch.equal(ragged.ebc(idx.reshape(BATCH, -1)),
                           stacked.ebc(idx))
        assert torch.equal(ragged(dense, idx.reshape(BATCH, -1)),
                           stacked(dense, idx))


def test_the_collection_holds_one_flat_buffer():
    cfg = small_config().embedding
    ebc = EmbeddingBagCollection(cfg, device="cpu")
    assert ebc.tables.shape == (sum(ROWS), DIM)
    assert ebc.row_offsets.tolist() == [0, 3, 13, 53, 1053, 1060]
    assert ebc.row_offsets.dtype == torch.int64
    assert ebc.col_offsets.tolist() == [0, 1, 4, 6, 18, 19]
    assert ebc.table_order.tolist() == [3, 1, 2, 0, 4]
    assert list(ebc.state_dict()) == ["tables"]
    assert cfg.table_bytes() == sum(ROWS) * DIM * 4
    # rows drawn N(0, 1/D)
    assert float(ebc.tables.std()) == pytest.approx(DIM ** -0.5, rel=0.1)


def test_indices_of_the_wrong_width_are_refused():
    ebc = EmbeddingBagCollection(small_config().embedding, device="cpu")
    with pytest.raises(ValueError, match=r"indices must be \[B, 19\]"):
        ebc(ragged_indices(ROWS, BAGS)[:, :-1])
    with pytest.raises(ValueError, match="unweighted"):
        ebc(ragged_indices(ROWS, BAGS), torch.ones((BATCH, 19)))


@pytest.mark.parametrize("change, message", [
    (dict(pinned_rows=4), "pinning"),
    (dict(combine="mean"), "combine 'mean'"),
    (dict(storage="tiered"), "storage 'tiered'"),
    (dict(storage="sharded"), "storage 'sharded'"),
    (dict(storage="pool"), "storage 'pool'"),
    (dict(shard_pad_tables=2), "shard_pad_tables"),
])
def test_refused_at_construction(change, message):
    cfg = dataclasses.replace(small_config().embedding, **change)
    with pytest.raises(ValueError, match=message):
        EmbeddingBagCollection(cfg, device="cpu")


def test_refused_plans_updates_and_sharding():
    cfg = small_config()
    with pytest.raises(ValueError, match="pinning"):
        EmbeddingBagCollection(cfg.embedding, plans=[], device="cpu")
    model = DLRM(cfg, device="cpu")
    storage = model.ebc.storage
    assert not storage.capabilities().updatable
    with pytest.raises(ValueError, match="no online updates"):
        storage.begin_update(1)
    with pytest.raises(Exception, match="updatable"):
        ServingSession(model, controllers=configure(
            updates=UpdateConfig(stream=types.SimpleNamespace(
                poll=lambda: []))))
    with pytest.raises(ValueError, match="table-wise"):
        make_dlrm_serve_step(cfg, None, batch=4)


def test_the_kernel_wrapper_takes_only_cuda_tables():
    ebc = EmbeddingBagCollection(small_config().embedding, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        embedding_bag_ragged_cuda(ebc.tables, ragged_indices(ROWS, BAGS),
                                  ebc.row_offsets, ebc.col_offsets,
                                  ebc.table_order)


@pytest.mark.parametrize("rows, bags, message", [
    ((3, 10), (1,), "2 table sizes and 1 bag sizes"),
    ((3,), (1, 2), "1 table sizes and 2 bag sizes"),
    ((3, 10), (1, 0), "must be positive"),
    ((3, 0), (1, 2), "must be positive"),
    ((), (1,), "0 table sizes"),
    ((2**31,), (1,), "at most 2\\*\\*31 - 1 rows"),
])
def test_the_config_is_validated(rows, bags, message):
    with pytest.raises(ValueError, match=message):
        RaggedStageConfig(dim=DIM, table_rows=rows, table_pooling=bags)


def test_the_config_counts_its_tables():
    cfg = RaggedStageConfig(dim=DIM, table_rows=[3, 10],
                            table_pooling=[2, 5])
    assert cfg.ragged and cfg.num_tables == 2
    assert cfg.table_rows == (3, 10) and cfg.table_pooling == (2, 5)
    assert dataclasses.replace(cfg, dtype="bfloat16").table_rows == (3, 10)
    assert not EmbeddingStageConfig().ragged
    # the stacked stage keeps exactly its own fields
    assert "table_rows" not in {
        f.name for f in dataclasses.fields(EmbeddingStageConfig)}
    layout = RaggedLayout((3, 10, 7), (2, 5, 5))
    assert layout.cols == 12 and layout.table_order() == [1, 2, 0]
    assert layout.row_offsets() == [0, 3, 13, 20]


def test_published_widths():
    assert "dlrm-dcnv2" in ALL_ARCHS
    cfg = get_config("dlrm-dcnv2")
    emb = cfg.embedding
    assert emb.table_rows == (
        40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
        3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
        40000000, 40000000, 590152, 12973, 108, 36)
    assert emb.table_pooling == (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6,
                                 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)
    assert (emb.num_tables, sum(emb.table_rows), sum(emb.table_pooling)) == (
        26, 204_184_588, 214)
    assert (emb.dim, emb.dtype, emb.combine, emb.storage) == (
        128, "bfloat16", "sum", "device")
    assert emb.table_bytes() == 52_271_254_528
    assert (cfg.dense_features, cfg.bottom_mlp, cfg.top_mlp) == (
        13, (512, 256, 128), (1024, 1024, 512, 256, 1))
    assert (cfg.interaction, cfg.dcn_layers, cfg.dcn_rank, cfg.dtype) == (
        "dcn", 3, 512, "float32")
    assert cfg.interaction_dim() == 27 * 128
    model = DLRM(cfg, device="meta")
    assert model.ebc.tables.shape == (204_184_588, 128)
    assert model.ebc.tables.dtype == torch.bfloat16
    assert model.cross.v0.shape == (3456, 512)
    assert model.cross.w2.shape == (512, 3456)
    assert sum(p.numel() for p in model.parameters()) == 16_044_545


def test_cross_network_is_the_formula():
    gen = torch.Generator().manual_seed(0)
    net = LowRankCrossNet(12, 3, 4, torch.float32, generator=gen,
                          device="cpu")
    assert [tuple(p.shape) for p in net.parameters()] == [
        (12, 4), (4, 12), (12,)] * 3
    assert all(not net.get_parameter(f"b{i}").any() for i in range(3))
    x0 = torch.randn((6, 12), generator=gen)
    x = x0
    for i in range(3):
        v, w, b = (net.get_parameter(f"{n}{i}") for n in "vwb")
        x = x0 * ((x @ v) @ w + b) + x
    torch.testing.assert_close(net(x0), x, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="rank >= 1"):
        LowRankCrossNet(12, 1, 0, torch.float32, generator=gen, device="cpu")


def test_cross_span_opens_once_a_forward(tmp_path):
    model = DLRM(small_config(), device="cpu", seed=3)
    idx, dense = ragged_indices(ROWS, BAGS), dense_inputs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            for _ in range(2):
                model(dense, idx)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e["name"] == tracing.PREFIX + name)

    cross, interact = spans("dlrm.cross"), spans("dlrm.interact")
    assert len(cross) == len(interact) == len(spans("dlrm.forward")) == 2
    assert all(i[0] <= c[0] and c[1] <= i[1]
               for c, i in zip(cross, interact))
    # on the CPU the plain gather runs: the kernel's span does not open
    assert spans("embedding_bag.ragged_launch") == []
    assert spans("ebc.lookup") and len(spans("ebc.lookup")) == 2
