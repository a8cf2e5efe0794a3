"""The DLRM cells: inputs from the seed, the program under test, its
reference, and the work a batch needs.

The program is `repro_torch.models.dlrm.DLRM` on the configuration's
`EmbeddingStageConfig` (storage `device`: the CUDA bag kernel on the
card), handed the tables and the MLP weights that the benchmark made. The
timed call is `DLRM.forward(dense, indices)`, the call the `device`
serving engine makes for each batch.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from bench.harness import hotness
from bench.reference import dlrm as reference

# keys of a configuration file that `DLRMConfig` / `EmbeddingStageConfig`
# take; the kernel's tuning knobs keep the program's defaults
MODEL_KEYS = ("dense_features", "bottom_mlp", "top_mlp", "interaction",
              "dtype")
STAGE_KEYS = ("num_tables", "rows", "dim", "pooling", "dtype", "combine",
              "storage", "shard_pad_tables")
TABLE_CHUNK = 32            # tables drawn by one call


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""

    tables: torch.Tensor                 # [T + pad, R, D]
    bottom: list                         # [(w [in, out], b [out])]
    top: list
    pool: list                           # [(dense [B, F], indices [B, T, L])]


def towers(cfg: dict):
    bottom = [cfg["dense_features"], *cfg["bottom_mlp"]]
    t = cfg["num_tables"] + 1
    width = (cfg["bottom_mlp"][-1] + t * (t - 1) // 2
             if cfg["interaction"] == "dot" else cfg["bottom_mlp"][-1] * t)
    return (list(zip(bottom[:-1], bottom[1:])),
            list(zip([width, *cfg["top_mlp"][:-1]], cfg["top_mlp"])))


def _dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def make_inputs(cfg: dict, traffic: dict, seed: int,
                device: torch.device) -> Inputs:
    """The pool of batches, the MLP weights and the tables, drawn on
    `device` from one generator seeded with `seed`, in that order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dtype(cfg)
    sampler = hotness.HotnessSampler(
        tables=cfg["num_tables"], rows=cfg["rows"],
        alpha=traffic["zipf_alpha"], generator=gen)
    pool = []
    for _ in range(traffic["pool_batches"]):
        idx = sampler.sample(traffic["batch"], cfg["pooling"])
        dense = torch.rand((traffic["batch"], cfg["dense_features"]),
                           generator=gen, device=device, dtype=dt)
        pool.append((dense, idx))
    del sampler

    def layer(fan_in, fan_out):
        w = torch.empty((fan_in, fan_out), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(1.0 / math.sqrt(fan_in))
        b = torch.randn((fan_out,), generator=gen, device=device) * 0.05
        return w.to(dt), b.to(dt)

    bottom_dims, top_dims = towers(cfg)
    bottom = [layer(i, o) for i, o in bottom_dims]
    top = [layer(i, o) for i, o in top_dims]
    shape = (cfg["num_tables"] + cfg["shard_pad_tables"], cfg["rows"],
             cfg["dim"])
    tables = torch.empty(shape, dtype=dt, device=device)
    for t0 in range(0, shape[0], TABLE_CHUNK):
        chunk = tables[t0:t0 + TABLE_CHUNK]
        torch.randn(chunk.shape, generator=gen, device=device, dtype=dt,
                    out=chunk)
        chunk.mul_(1.0 / math.sqrt(cfg["dim"]))
    return Inputs(tables=tables, bottom=bottom, top=top, pool=pool)


def build_program(cfg: dict, inputs: Inputs, device: torch.device):
    """`DLRM` on the benchmark's tables (adopted, not copied) with the
    benchmark's MLP weights loaded through its state dict."""
    from repro_torch.core.embedding import EmbeddingStageConfig
    from repro_torch.models.dlrm import DLRM, DLRMConfig

    stage = EmbeddingStageConfig(**{k: cfg[k] for k in STAGE_KEYS})
    model_cfg = DLRMConfig(
        embedding=stage,
        **{k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]
           for k in MODEL_KEYS})
    model = DLRM(model_cfg, device=device, tables=inputs.tables)
    state = {}
    for tower, layers in (("bottom", inputs.bottom), ("top", inputs.top)):
        for i, (w, b) in enumerate(layers):
            state[f"{tower}.w{i}"] = w
            state[f"{tower}.b{i}"] = b
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
    embedding stage's pooled bags [B, T, D]."""
    return model.ebc


def reference_outputs(cfg: dict, inputs: Inputs, k: int,
                      lower: bool = False):
    """(pooled [B, T, D], logits [B]) of pool batch `k` by the plain
    reference, or by the control with `lower`."""
    dense, idx = inputs.pool[k]
    bags = reference.pooled(inputs.tables, idx, cfg["combine"], lower=lower)
    return bags, reference.logits(inputs.bottom, inputs.top, dense, bags,
                                  lower=lower)


def work(cfg: dict, inputs: Inputs, k: int) -> dict:
    """What pool batch `k` needs at least, whatever implements it.

    bag_bytes: the embedding stage reads each distinct (table, row) once
    and each int32 index once, and writes each pooled bag once.
    step_bytes: the whole step reads each distinct row, each index, the
    dense features and every MLP weight once, and writes the logits once.
    step_flops: the MLP products (2 in out a query and layer, bias
    included), the pooling adds (L - 1 a bag and column) and the dot
    interaction (2D - 1 for each pair).
    """
    dense, idx = inputs.pool[k]
    batch, num_tables, pooling = idx.shape
    dim = cfg["dim"]
    item = _dtype(cfg).itemsize
    distinct = hotness.distinct_rows(idx, cfg["rows"])
    bottom_dims, top_dims = towers(cfg)
    weights = sum(i * o + o for i, o in bottom_dims + top_dims) * item
    mlp_flops = sum(2 * batch * i * o for i, o in bottom_dims + top_dims)
    pool_flops = batch * num_tables * (pooling - 1) * dim
    n = num_tables + 1
    pairs = n * (n - 1) // 2 if cfg["interaction"] == "dot" else 0
    rows_bytes = distinct * dim * item
    index_bytes = idx.numel() * 4
    return {
        "distinct_rows": distinct,
        "bag_bytes": rows_bytes + index_bytes
        + batch * num_tables * dim * item,
        "step_bytes": rows_bytes + index_bytes + dense.numel() * item
        + weights + batch * item,
        "step_flops": mlp_flops + pool_flops + batch * pairs * (2 * dim - 1),
    }
