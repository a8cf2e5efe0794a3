"""EmbeddingBagCollection — the paper's embedding stage as an `nn.Module`.

Owns a stack of homogeneous embedding tables [T, R, D] as a registered
buffer, the per-table hot-first plans (L2 pinning), and the kernel tuning
knobs. Every table is pooled by ONE kernel launch over indices [B, T, L]
(the TPU path vmaps one launch per table), matching the paper's "each GPU
executes one or more embedding tables" with the tables on the grid.

Storage is pluggable: `EmbeddingStageConfig.storage` names a backend in the
`repro_torch.storage` registry (`device`: tables fully resident in device
memory; `tiered`: the hot/warm/cold parameter server), and `forward()`
delegates to `self.storage.lookup(...)`. For a host-backed backend
(`capabilities().device_resident` False) the collection keeps `tables` on
the host, where they become the backend's cold tier as they are, so the
host holds the one copy; the pooled output still lands on `device`.

Training: `tables.requires_grad_(True)` makes the buffer a leaf that
autograd differentiates through a `device` lookup (the kernel's backward
on the card, the plain gather's on the CPU); it keeps its state-dict key
`ebc.tables`. The host-backed backends cannot differentiate their
lookups (nor can the TPU path's): a lookup through them that needs a
gradient raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import hot_cache
from repro_torch.kernels.embedding_bag import EmbeddingBagOpts, RaggedLayout
from repro_torch.tracing import span
from repro_torch.utils import resolve_device, torch_dtype


def gather_rows(tables: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """tables [T', R, D], indices [B, T, L] -> rows [B, T, L, D] (T <= T')."""
    t = torch.arange(indices.shape[1], device=indices.device)[None, :, None]
    return tables[t, indices.long()]


def _pool_rows_core(rows: torch.Tensor, weights: torch.Tensor | None,
                    combine: str) -> torch.Tensor:
    """Pool gathered rows [B, T, L, D] -> [B, T, D]: the plain version of
    the embedding stage, with the CUDA kernel's semantics.

    A weighted mean divides by max(Σw, 1e-9) and an unweighted one by L, as
    `ref.embedding_bag_ref` and the Pallas kernel do. (The TPU path's XLA
    route divides a weighted mean by `cfg.pooling` instead; ROADMAP.md
    Queue 3 records that disagreement as a fault of the reference.)
    """
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    pooled = rows.sum(dim=2)
    if combine == "mean":
        if weights is not None:
            pooled = pooled / weights.sum(dim=2).clamp_min(1e-9)[..., None]
        else:
            pooled = pooled / rows.shape[2]
    elif combine != "sum":
        raise ValueError(f"unknown combine {combine!r}")
    return pooled


#: rows one call draws when a collection draws ragged tables, in place:
#: 40 M-row tables are drawn by launches of bounded size
RAGGED_DRAW_ROWS = 1 << 22


@dataclasses.dataclass(frozen=True)
class EmbeddingStageConfig:
    num_tables: int = 250          # paper §V
    rows: int = 500_000
    dim: int = 128
    pooling: int = 150
    dtype: str = "float32"         # paper: 4-byte precision
    combine: str = "sum"           # bag pooling mode
    # Storage backend name, resolved in the repro_torch.storage registry
    storage: str = "device"
    # ring depth of the lookup kernels (row slots per warp in shared
    # memory) and bags per thread block: the fastest on an H100 (PERF.md)
    prefetch_distance: int = 4
    batch_block: int = 8
    pinned_rows: int = 0           # K per table; paper: 60K rows across L2
    # extra tables stacked after the real ones so the stack divides a
    # device count (whole-table sharding); never looked up. 0 = none.
    shard_pad_tables: int = 0

    #: tables of different sizes: `RaggedStageConfig`
    ragged = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def table_bytes(self) -> int:
        return (self.num_tables * self.rows * self.dim
                * self.torch_dtype.itemsize)

    def kernel_opts(self) -> EmbeddingBagOpts:
        return EmbeddingBagOpts(
            prefetch_distance=self.prefetch_distance,
            batch_block=self.batch_block,
            num_hot=self.pinned_rows,
            mode=self.combine,
        )


@dataclasses.dataclass(frozen=True)
class RaggedStageConfig(EmbeddingStageConfig):
    """An embedding stage of tables of different sizes: the rows and the
    lookups a bag of each table. `num_tables` is their length, `rows` and
    `pooling` are not read, and the collection holds the tables as one
    flat [sum(table_rows), dim] buffer (`kernels.embedding_bag
    .RaggedLayout`). The stacked stage's fields stay as they are, so its
    config still names exactly the JAX package's fields."""

    table_rows: tuple[int, ...] = ()
    table_pooling: tuple[int, ...] = ()

    ragged = True

    def __post_init__(self):
        rows, pooling = tuple(self.table_rows), tuple(self.table_pooling)
        RaggedLayout(rows, pooling)          # raises on a bad pair
        object.__setattr__(self, "table_rows", rows)
        object.__setattr__(self, "table_pooling", pooling)
        object.__setattr__(self, "num_tables", len(rows))

    def layout(self) -> RaggedLayout:
        return RaggedLayout(self.table_rows, self.table_pooling)

    def table_bytes(self) -> int:
        return sum(self.table_rows) * self.dim * self.torch_dtype.itemsize


class EmbeddingBagCollection(nn.Module):
    """Tables [T(+pad), R, D] as the buffer `tables`; `ebc(indices)` ->
    pooled [B, T, D] on `self.device` through the bound storage backend
    `self.storage`.

    `tables`, when given, are adopted instead of drawn from `generator`
    (moved to `device` for a device-resident backend, kept on the host
    otherwise); they must be stored hot-first when `pinned_rows > 0`."""

    def __init__(self, cfg: EmbeddingStageConfig,
                 plans: Optional[list[hot_cache.HotPlan]] = None, *,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 tables: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.device = device
        # Resolve the backend FIRST: unknown names fail before any
        # allocation. Lazy import: storage imports core.embedding.
        from repro_torch import storage as storage_registry
        if cfg.ragged:
            self._check_ragged(plans)
        self.storage = storage_registry.create(cfg.storage, self)
        resident = self.storage.capabilities().device_resident
        if cfg.ragged:
            self._init_ragged(generator, tables)
            return
        # One plan per table; identity when pinning is off.
        if plans is None:
            plans = [hot_cache.identity_plan(cfg.rows, cfg.pinned_rows)
                     for _ in range(cfg.num_tables)]
        if len(plans) != cfg.num_tables:
            raise ValueError(f"{len(plans)} plans for {cfg.num_tables} tables")
        self.plans = plans
        # [T, R] stacked remap, applied to raw indices before lookup.
        self.register_buffer("_remap", (
            torch.as_tensor(np.stack([p.inv_perm for p in plans]),
                            dtype=torch.int32, device=device)
            if cfg.pinned_rows > 0 else None), persistent=False)
        shape = (cfg.num_tables + cfg.shard_pad_tables, cfg.rows, cfg.dim)
        if tables is not None:
            if tuple(tables.shape) != shape or tables.dtype != cfg.torch_dtype:
                raise ValueError(f"tables {tuple(tables.shape)} "
                                 f"{tables.dtype} != {list(shape)} "
                                 f"{cfg.torch_dtype}")
            self.register_buffer("tables", tables.to(
                device if resident else "cpu"))
            return
        if device.type == "meta":        # shapes only (the dry-run)
            self.register_buffer("tables", torch.empty(
                shape, dtype=cfg.torch_dtype, device=device))
            return
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        # N(0, 1/D) rows, made on the generator's device: a device-resident
        # collection's tables never exist on the host; a host-backed one
        # draws the same values, then keeps them on the host
        tables = torch.randn(shape, generator=generator,
                             dtype=cfg.torch_dtype, device=generator.device)
        tables.mul_(1.0 / np.sqrt(cfg.dim))
        if not resident:
            tables = tables.cpu()
        if cfg.pinned_rows > 0:
            # Store hot-first (offline, one-time — like the paper's pinning
            # kernel launched before the embedding bag kernel).
            for t in range(tables.shape[0]):
                plan = self.plans[t] if t < cfg.num_tables else self.plans[0]
                tables[t] = plan.reorder_table(tables[t])
        self.register_buffer("tables", tables)

    def _check_ragged(self, plans) -> None:
        """Refuse what the ragged path does not handle, before anything is
        allocated."""
        cfg = self.cfg
        refused = []
        if cfg.storage != "device":
            refused.append(f"storage {cfg.storage!r} (only 'device')")
        if cfg.pinned_rows > 0 or plans is not None:
            refused.append("hot-row pinning (pinned_rows > 0 or plans)")
        if cfg.combine != "sum":
            refused.append(f"combine {cfg.combine!r} (only 'sum')")
        if cfg.shard_pad_tables:
            refused.append("shard_pad_tables (table-wise sharding)")
        if refused:
            raise ValueError("tables of different sizes (RaggedStageConfig) "
                             "take none of: " + "; ".join(refused))

    def _init_ragged(self, generator, tables) -> None:
        """Tables of different sizes: one flat buffer `tables` [sum R, D],
        the layout (`self.layout`) and its offsets on `device`. Drawn N(0, 1/D) in chunks of
        rows, on the generator's device, unless `tables` are given."""
        cfg, device = self.cfg, self.device
        self.layout = layout = cfg.layout()
        self.plans = None
        self.register_buffer("_remap", None, persistent=False)
        for name, values, dtype in (
                ("row_offsets", layout.row_offsets(), torch.int64),
                ("col_offsets", layout.col_offsets(), torch.int32),
                ("table_order", layout.table_order(), torch.int32)):
            self.register_buffer(name, torch.tensor(
                values, dtype=dtype, device=device), persistent=False)
        shape = (sum(layout.rows), cfg.dim)
        if tables is not None:
            if tuple(tables.shape) != shape or tables.dtype != cfg.torch_dtype:
                raise ValueError(f"tables {tuple(tables.shape)} "
                                 f"{tables.dtype} != {list(shape)} "
                                 f"{cfg.torch_dtype}")
            self.register_buffer("tables", tables.to(device))
            return
        flat = torch.empty(shape, dtype=cfg.torch_dtype, device=device)
        if device.type != "meta":
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            for r0 in range(0, shape[0], RAGGED_DRAW_ROWS):
                chunk = flat[r0:r0 + RAGGED_DRAW_ROWS]
                torch.randn(chunk.shape, generator=generator,
                            dtype=chunk.dtype, device=device, out=chunk)
                chunk.mul_(1.0 / np.sqrt(cfg.dim))
        self.register_buffer("tables", flat)

    def remap_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Raw row ids -> hot-first ids. indices: [B, T, L] int32."""
        if self._remap is None:
            return indices
        b = indices.shape[0]
        return torch.gather(self._remap.expand(b, -1, -1), 2,
                            indices.long())

    # -- data path ----------------------------------------------------------
    def forward(self, indices: torch.Tensor,
                weights: torch.Tensor | None = None, *,
                pre_remapped: bool = False) -> torch.Tensor:
        """indices: [B, T, L] int32 -> pooled [B, T, D] (the TPU path's
        `apply`; `nn.Module.apply` keeps its own meaning here).

        Tables of different sizes (a `RaggedStageConfig`) take indices
        [B, sum(table_pooling)] int32 instead: table t's ids sit at columns
        [off_t, off_t + L_t), off_t the sum of the bag sizes before it, and
        each lies in [0, table_rows[t]); the pooled bags [B, T, D] are then
        float32 whatever the tables' type.

        Thin delegation into the bound storage backend."""
        if (self.tables.requires_grad and torch.is_grad_enabled()
                and not self.storage.capabilities().device_resident):
            raise RuntimeError(
                f"storage {self.cfg.storage!r} cannot differentiate its "
                f"host lookup, and the tables require a gradient: train on "
                f"storage='device', or look up under torch.no_grad()")
        with span("ebc.lookup"):
            return self.storage.lookup(indices, weights,
                                       pre_remapped=pre_remapped)
