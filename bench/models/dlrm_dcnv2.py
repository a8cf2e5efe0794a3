"""The DLRM-DCNv2 cell: MLPerf's recommendation model (26 tables of 3 to
40 M rows, a multi-hot bag size a table, a low-rank cross network). Inputs
from the seed, the program under test, its reference, and the work a
batch needs.

The program is `repro_torch.models.dlrm.DLRM` with interaction "dcn" on
a `RaggedStageConfig`, tables of different sizes (`table_rows`,
`table_pooling`; storage `device`: the ragged bag kernel on the card),
handed the tables and the dense weights that the benchmark made. The timed
call is `DLRM.forward(dense, indices)` with indices [B, sum L] int32:
table t's ids at its own columns, each in [0, R_t).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from bench.harness import hotness
from bench.reference import dlrm_dcnv2 as reference

TABLE_CHUNK_ROWS = 1 << 24  # rows drawn by one call


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""

    tables: torch.Tensor                 # [sum R, D]
    bottom: list                         # [(w [in, out], b [out])]
    cross: list                          # [(v [dim, rank], w [rank, dim], b)]
    top: list
    pool: list                           # [(dense [B, F], indices [B, sum L])]


def towers(cfg: dict):
    bottom = [cfg["dense_features"], *cfg["bottom_mlp"]]
    width = cross_width(cfg)
    return (list(zip(bottom[:-1], bottom[1:])),
            list(zip([width, *cfg["top_mlp"][:-1]], cfg["top_mlp"])))


def cross_width(cfg: dict) -> int:
    return (len(cfg["num_embeddings_per_feature"]) + 1) * cfg["dim"]


def _require_ragged_program() -> None:
    """Fail at once, before 52 GB of tables are drawn, on a program whose
    embedding stage takes no tables of different sizes."""
    from repro_torch.core import embedding
    if not hasattr(embedding, "RaggedStageConfig"):
        raise RuntimeError("the program has no RaggedStageConfig: it cannot "
                           "hold tables of different sizes")


def make_inputs(cfg: dict, traffic: dict, seed: int,
                device: torch.device) -> Inputs:
    """The pool of batches, the dense weights and the tables, drawn on
    `device` from one generator seeded with `seed`, in that order. Each
    table's ids come from a sampler of its own (Zipf over its own rows,
    its own rank -> row permutation), for every pool batch at once."""
    _require_ragged_program()
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg["dtype"])
    batch, batches = traffic["batch"], traffic["pool_batches"]
    ids = []
    for rows, pool in zip(cfg["num_embeddings_per_feature"],
                          cfg["multi_hot_sizes"]):
        sampler = hotness.HotnessSampler(
            tables=1, rows=rows, alpha=traffic["zipf_alpha"], generator=gen)
        ids.append(sampler.sample(batches * batch, pool).reshape(
            batches, batch, pool))
        del sampler
    pool = []
    for k in range(batches):
        idx = torch.cat([t[k] for t in ids], dim=1).contiguous()
        dense = torch.rand((batch, cfg["dense_features"]), generator=gen,
                           device=device, dtype=dt)
        pool.append((dense, idx))
    del ids

    def bias(n):
        return (torch.randn((n,), generator=gen, device=device)
                * 0.05).to(dt)

    def layer(fan_in, fan_out):
        w = torch.empty((fan_in, fan_out), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(1.0 / math.sqrt(fan_in))
        return w.to(dt), bias(fan_out)

    def xavier(shape):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.xavier_normal_(w, generator=gen)
        return w.to(dt)

    bottom_dims, top_dims = towers(cfg)
    bottom = [layer(i, o) for i, o in bottom_dims]
    width, rank = cross_width(cfg), cfg["dcn_rank"]
    cross = [(xavier((width, rank)), xavier((rank, width)), bias(width))
             for _ in range(cfg["dcn_layers"])]
    top = [layer(i, o) for i, o in top_dims]
    tables = torch.empty((sum(cfg["num_embeddings_per_feature"]),
                          cfg["dim"]),
                         dtype=getattr(torch, cfg["table_dtype"]),
                         device=device)
    for r0 in range(0, tables.shape[0], TABLE_CHUNK_ROWS):
        chunk = tables[r0:r0 + TABLE_CHUNK_ROWS]
        torch.randn(chunk.shape, generator=gen, device=device,
                    dtype=chunk.dtype, out=chunk)
        chunk.mul_(1.0 / math.sqrt(cfg["dim"]))
    return Inputs(tables=tables, bottom=bottom, cross=cross, top=top,
                  pool=pool)


def build_program(cfg: dict, inputs: Inputs, device: torch.device):
    """`DLRM` with interaction "dcn" on the benchmark's tables (adopted,
    not copied), with the benchmark's dense weights loaded through its
    state dict."""
    from repro_torch.core.embedding import RaggedStageConfig
    from repro_torch.models.dlrm import DLRM, DLRMConfig

    stage = RaggedStageConfig(
        dim=cfg["dim"], dtype=cfg["table_dtype"], combine=cfg["combine"],
        storage=cfg["storage"],
        table_rows=tuple(cfg["num_embeddings_per_feature"]),
        table_pooling=tuple(cfg["multi_hot_sizes"]))
    model_cfg = DLRMConfig(
        dense_features=cfg["dense_features"],
        bottom_mlp=tuple(cfg["bottom_mlp"]), top_mlp=tuple(cfg["top_mlp"]),
        embedding=stage, interaction=cfg["interaction"],
        dcn_layers=cfg["dcn_layers"], dcn_rank=cfg["dcn_rank"],
        dtype=cfg["dtype"])
    model = DLRM(model_cfg, device=device, tables=inputs.tables)
    state = {}
    for tower, layers in (("bottom", inputs.bottom), ("top", inputs.top)):
        for i, (w, b) in enumerate(layers):
            state[f"{tower}.w{i}"] = w
            state[f"{tower}.b{i}"] = b
    for i, (v, w, b) in enumerate(inputs.cross):
        state.update({f"cross.v{i}": v, f"cross.w{i}": w, f"cross.b{i}": b})
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or set(missing) != {"ebc.tables"}:
        raise RuntimeError(f"state dict: missing {missing}, "
                           f"unexpected {unexpected}")
    return model.eval()


def step(model, dense: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The timed call: logits [B] of one batch."""
    return model(dense, indices)


def layers(model) -> dict:
    """Modules whose calls the traced run marks as ranges."""
    return {"bottom": model.bottom, "ebc": model.ebc, "top": model.top}


def checked_module(model):
    """The module whose output the check compares beside the logits: the
    embedding stage's pooled bags [B, T, D] float32."""
    return model.ebc


def reference_outputs(cfg: dict, inputs: Inputs, k: int,
                      lower: bool = False):
    """(pooled [B, T, D], logits [B]) of pool batch `k` by the plain
    reference, or by the control with `lower`."""
    dense, idx = inputs.pool[k]
    bags = reference.pooled(inputs.tables, cfg["num_embeddings_per_feature"],
                            cfg["multi_hot_sizes"], idx, lower=lower)
    return bags, reference.logits(inputs.bottom, inputs.cross, inputs.top,
                                  dense, bags, lower=lower)


def distinct_rows(cfg: dict, indices: torch.Tensor) -> int:
    """Distinct (table, row) pairs of one batch [B, sum L]: what the
    embedding stage must read from memory at least once."""
    base = torch.tensor([0, *cfg["num_embeddings_per_feature"][:-1]],
                        dtype=torch.int64, device=indices.device).cumsum(0)
    cols = torch.repeat_interleave(
        base, torch.tensor(cfg["multi_hot_sizes"], device=indices.device))
    return int(torch.unique(indices.long() + cols).numel())


def work(cfg: dict, inputs: Inputs, k: int) -> dict:
    """What pool batch `k` needs at least, whatever implements it.

    bag_bytes: the embedding stage reads each distinct (table, row) once,
    each int32 index once, and writes each pooled bag once in float32.
    cross_flops: the cross network's two products a layer (2 dim rank
    each a sample) and its bias add, product and sum (3 dim).
    step_bytes: the whole step reads each distinct row, each index, the
    dense features and every dense weight once, and writes the logits.
    step_flops: the MLP products (2 in out a sample and layer), the
    pooling adds (L_t - 1 a bag and column) and `cross_flops`.
    """
    dense, idx = inputs.pool[k]
    batch = idx.shape[0]
    dim, tables = cfg["dim"], len(cfg["multi_hot_sizes"])
    row_item = getattr(torch, cfg["table_dtype"]).itemsize
    item = getattr(torch, cfg["dtype"]).itemsize
    distinct = distinct_rows(cfg, idx)
    bottom_dims, top_dims = towers(cfg)
    width, rank, n = cross_width(cfg), cfg["dcn_rank"], cfg["dcn_layers"]
    params = (sum(i * o + o for i, o in bottom_dims + top_dims)
              + n * (2 * width * rank + width))
    mlp_flops = sum(2 * batch * i * o for i, o in bottom_dims + top_dims)
    pool_flops = batch * sum(p - 1 for p in cfg["multi_hot_sizes"]) * dim
    cross_flops = n * batch * (4 * width * rank + 3 * width)
    rows_bytes = distinct * dim * row_item
    index_bytes = idx.numel() * 4
    return {
        "distinct_rows": distinct,
        "bag_bytes": rows_bytes + index_bytes + batch * tables * dim * 4,
        "cross_flops": cross_flops,
        "step_bytes": rows_bytes + index_bytes + dense.numel() * item
        + params * item + batch * item,
        "step_flops": mlp_flops + pool_flops + cross_flops,
    }
