"""`device` backend — tables fully resident in device memory.

`lookup()` is the dense path: hot-first remap, then one launch of the CUDA
embedding-bag kernel over every table when the tables lie on a CUDA
device, or the plain gather + `_pool_rows_core` when they lie on the CPU.
Tables on the card always launch the kernel (or raise): nothing there
selects the plain version. The launch goes through
`kernels.embedding_bag.EmbeddingBagFunction`, so tables that require a
gradient (training) get one from its backward; a lookup that asks for no
gradient launches the same kernel with the same bits. On the CPU autograd
differentiates the plain gather itself.

Tables of different sizes (a `RaggedStageConfig`) are one
flat [sum R, D] buffer, looked up by `_lookup_ragged`: one launch of the
ragged bag kernel on the card, the plain per-table gather on the CPU. It
takes unweighted sum bags only, and no online update, hot-row remap or
table-wise sharding.

No staging, no refresh: with everything resident there is nothing to
overlap or re-pin at the storage level (the paper's in-kernel prefetch and
hot-row operand live inside the kernel itself, selected by
`EmbeddingStageConfig.prefetch_distance`/`pinned_rows`).

Under a mesh (the step functions of `repro_torch.launch.steps` make the
tables a DTensor, table-wise sharded) the lookup pins the table-parallel
layout end to end, as the TPU path does: the indices (padded with
`shard_pad_tables` empty tables) reshard to the tables' owners, each rank
runs the same lookup (the kernel on the card) on its local tables inside
a `shard_map_compat` region, and only pooled outputs travel back.
"""
from __future__ import annotations

import torch

from repro_torch.core.update import UpdateTxn, require_open
from repro_torch.kernels.embedding_bag import (EmbeddingBagFunction,
                                               embedding_bag_ragged_cuda,
                                               ragged_tables_bag_ref)
from repro_torch.models import pspec
from repro_torch.models.pspec import P
from repro_torch.storage.base import EmbeddingStorage, StorageCapabilities
from repro_torch.storage.registry import register
from repro_torch.utils import shard_map_compat, to_tensor


def _pad_tables(x: torch.Tensor, pad: int) -> torch.Tensor:
    """[T, ...] -> [T + pad, ...], zeros after (empty tables)."""
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], dim=0)


@register("device")
class DeviceStorage(EmbeddingStorage):
    """Dense device-resident storage: the collection's `tables` buffer IS
    the storage.

    Online updates therefore write the bound collection's tables: on
    `commit_update` the changed rows are written IN PLACE into
    `ebc.tables` (`index_put_`, under `torch.no_grad()`, so tables being
    trained take updates too), so the engine, which reads the module's
    tensors on every call, sees them on the NEXT forward. Logical row ids
    route through the EBC's hot-first remap, since the stored tables are
    physically permuted when `pinned_rows > 0`."""

    def __init__(self, ebc):
        super().__init__(ebc)
        self._version = 0
        self._update_txn = None

    def capabilities(self) -> StorageCapabilities:
        return StorageCapabilities(device_resident=True,
                                   updatable=not self.cfg.ragged)

    # -- online model updates -------------------------------------------------
    def version(self) -> int:
        return self._version

    def begin_update(self, version: int) -> bool:
        if not self.capabilities().updatable:
            raise ValueError("tables of different sizes take no online "
                             "updates")
        if self._update_txn is not None:
            raise RuntimeError(
                f"an update to v{self._update_txn.version} is already "
                f"open — commit or abort it first")
        self._update_txn = UpdateTxn(version, self._version)
        return True

    def apply_update(self, table: int, rows, values) -> bool:
        cfg = self.cfg
        require_open(self._update_txn, "apply_update").add(
            table, rows, values, num_tables=cfg.num_tables,
            num_rows=cfg.rows, dim=cfg.dim, dtype=cfg.dtype)
        return True

    def commit_update(self, version: int) -> dict:
        txn = require_open(self._update_txn, "commit_update")
        txn.check_commit(version)
        merged = txn.merged()
        tables = self.ebc.tables
        applied = 0
        for t, (rows, vals) in merged.items():
            rows_t = torch.as_tensor(rows, device=tables.device)
            phys = (rows_t if self.ebc._remap is None
                    else self.ebc._remap[t][rows_t].long())
            # in place: the tables buffer is the one the engine reads
            with torch.no_grad():
                tables[t].index_put_(
                    (phys,), to_tensor(vals, tables.dtype).to(tables.device))
            applied += int(rows.size)
        self._version = txn.version
        self._update_txn = None
        return {"updated": True, "version": self._version,
                "rows": applied, "tables": len(merged)}

    def abort_update(self, version: int) -> bool:
        if self._update_txn is None:
            return False
        self._update_txn.check_commit(version)
        self._update_txn = None
        return True

    def lookup(self, indices: torch.Tensor, weights=None, *,
               pre_remapped: bool = False) -> torch.Tensor:
        """indices: [B, T, L] int32 -> pooled [B, T, D] (tables of
        different sizes: `_lookup_ragged`)."""
        if self.cfg.ragged:
            return self._lookup_ragged(indices, weights)
        if not pre_remapped:
            indices = self.ebc.remap_indices(indices)
        tables = self.ebc.tables                       # [T(+pad), R, D]
        if pspec.is_dtensor(tables):
            return self._lookup_tablewise(tables, indices, weights)
        return self._lookup_local(tables, indices, weights)

    def _lookup_local(self, tables, indices, weights):
        """Plain tensors: the kernel on the card, the plain gather and
        pooling on the CPU or meta. indices' T may be below the tables'
        (pad tables are never looked up: the grid covers indices' T)."""
        from repro_torch.core.embedding import _pool_rows_core, gather_rows
        if not tables.is_cuda:
            return _pool_rows_core(gather_rows(tables, indices), weights,
                                   self.cfg.combine)
        return EmbeddingBagFunction.apply(
            tables, indices.to(torch.int32).contiguous(),
            None if weights is None
            else weights.to(torch.float32).contiguous(),
            self.cfg.kernel_opts())

    def _lookup_ragged(self, indices, weights):
        """Tables of different sizes: indices [B, sum L_t] int32 -> pooled
        [B, T, D] float32; the ragged kernel on the card (one launch), the
        plain gather and pooling one table at a time on the CPU."""
        ebc = self.ebc
        layout = ebc.layout
        tables = ebc.tables
        if weights is not None:
            raise ValueError("tables of different sizes take unweighted "
                             "bags only")
        if pspec.is_dtensor(tables):
            raise ValueError("tables of different sizes cannot be sharded "
                             "table-wise")
        if indices.dim() != 2 or indices.shape[1] != layout.cols:
            raise ValueError(f"indices must be [B, {layout.cols}] (the bag "
                             f"sizes {layout.pooling} side by side), got "
                             f"{tuple(indices.shape)}")
        if not tables.is_cuda:
            return ragged_tables_bag_ref(tables, indices,
                                         layout.row_offsets(),
                                         layout.col_offsets())
        if tables.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("the ragged bag kernel has no backward: look "
                               "up under torch.no_grad()")
        return embedding_bag_ragged_cuda(
            tables, indices.to(torch.int32).contiguous(), ebc.row_offsets,
            ebc.col_offsets, ebc.table_order, self.cfg.kernel_opts())

    def _lookup_tablewise(self, tables, indices, weights):
        """The lookup on a table-wise sharded DTensor: `_lookup_local` on
        each rank's tables [T_loc, R, D] and indices [B, T_loc, L]."""
        cfg = self.cfg
        t_entry = pspec.spec_of(tables)[0]
        if any(p.is_shard() and p.dim != 0 for p in tables.placements):
            raise ValueError(
                f"tables placed {tables.placements}: the lookup runs on "
                f"whole local tables (shard dim 0 only)")
        mesh = tables.device_mesh
        idx_t = indices.transpose(0, 1)                # [T, B, L]
        w_t = None if weights is None else weights.transpose(0, 1)
        if cfg.shard_pad_tables:
            idx_t = _pad_tables(idx_t, cfg.shard_pad_tables)
            if w_t is not None:
                w_t = _pad_tables(w_t, cfg.shard_pad_tables)
        tw = P(t_entry, None, None)
        idx_t = pspec.constrain(idx_t, tw)
        specs = (tw, tw) + (() if w_t is None else (tw,))

        @shard_map_compat(mesh=mesh, in_specs=specs, out_specs=tw)
        def local(tab, idx, w=None):                   # [T_loc, ...]
            pooled = self._lookup_local(
                tab, idx.transpose(0, 1),
                None if w is None else w.transpose(0, 1))
            return pooled.transpose(0, 1).contiguous()  # [T_loc, B, D]

        pooled = local(tables, idx_t, *(() if w_t is None else (w_t,)))
        pooled = pspec.constrain_tablewise(pooled).transpose(0, 1)
        return pooled[:, :cfg.num_tables]
