"""Hot-row cache planning — the paper's L2 pinning (§IV-C) on an H100.

The paper pins the top-60K hottest embedding rows in the A100's 30MB L2
set-aside via `prefetch.global.L2::evict_last`. The port
(1) profiles a trace offline to find the top-K hot rows per table,
(2) physically reorders each table hot-first, and
(3) reads rows [0, K) through the kernel's separate hot operand, the
    region a persisting L2 access-policy window is meant to cover.

The remap is exact (a permutation), so lookups are bit-identical; only data
placement changes. `periodic refresh` (paper §IV-C "update the pinned data
periodically") is supported by re-planning from a sliding-window trace.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: H100 L2 cache size (NVIDIA data sheet).
H100_L2_BYTES = 50 * 10**6


@dataclasses.dataclass(frozen=True)
class HotPlan:
    """A hot-first permutation plan for one table."""

    num_rows: int
    num_hot: int
    perm: np.ndarray      # [R] new_pos -> old_row ; rows [0, num_hot) are hot
    inv_perm: np.ndarray  # [R] old_row -> new_pos (applied to indices)

    def remap_indices(self, indices):
        """old-row indices -> hot-first row indices (torch or np)."""
        if isinstance(indices, np.ndarray):
            return self.inv_perm.astype(indices.dtype)[indices]
        remap = torch.as_tensor(self.inv_perm, device=indices.device)
        return remap.to(indices.dtype)[indices.long()]

    def reorder_table(self, table):
        """Physically reorder the table hot-first (one-time, offline)."""
        if isinstance(table, np.ndarray):
            return table[self.perm]
        return table[torch.as_tensor(self.perm, device=table.device)]

    def pinned_bytes(self, dim: int, itemsize: int = 4) -> int:
        return self.num_hot * dim * itemsize


def profile_counts(trace: np.ndarray, num_rows: int) -> np.ndarray:
    """Offline profiling: per-row access counts from an index trace."""
    return np.bincount(trace.reshape(-1), minlength=num_rows).astype(np.int64)


def build_plan(counts: np.ndarray, num_hot: int) -> HotPlan:
    """Top-K hot rows by count -> hot-first permutation.

    Ties broken by row id for determinism. Rows never accessed still get
    stable cold positions.
    """
    num_rows = len(counts)
    num_hot = int(min(num_hot, num_rows))
    # argsort by (-count, row) for deterministic order
    order = np.lexsort((np.arange(num_rows), -counts)).astype(np.int64)
    perm = order  # new_pos -> old_row
    inv_perm = np.empty(num_rows, dtype=np.int64)
    inv_perm[perm] = np.arange(num_rows)
    return HotPlan(num_rows=num_rows, num_hot=num_hot, perm=perm, inv_perm=inv_perm)


def plan_from_trace(trace: np.ndarray, num_rows: int, num_hot: int) -> HotPlan:
    return build_plan(profile_counts(trace, num_rows), num_hot)


def identity_plan(num_rows: int, num_hot: int = 0) -> HotPlan:
    """No-reorder plan (e.g. tables already stored hot-first, or pinning off)."""
    ar = np.arange(num_rows, dtype=np.int64)
    return HotPlan(num_rows=num_rows, num_hot=num_hot, perm=ar, inv_perm=ar.copy())


def l2_budget_rows(dim: int, itemsize: int = 4,
                   l2_bytes: int = 3 * H100_L2_BYTES // 4) -> int:
    """How many rows fit an L2 pinning budget. The default budget is three
    quarters of the H100's 50 MB L2, leaving the rest to the cold rows
    streaming through it. Replaces the TPU path's `vmem_budget_rows`."""
    return max(0, l2_bytes // (dim * itemsize))
