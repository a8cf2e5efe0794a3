"""`tiered` backend — the hot/warm/cold parameter server behind the protocol.

Wraps `repro_torch.ps.ParameterServer` (hot block, LFU/LRU warm cache with
its payload on the card, host cold tier with sync/async prefetch staging)
and maps its surface one-to-one onto the `EmbeddingStorage` verbs, so the
generic serving drivers get prefetch overlap and periodic re-pinning with
no PS-specific code.

`build()` carries the construction logic: either an explicit `PSConfig`,
or trace-driven tier auto-tuning under a device byte budget
(`core.plan.plan_tier_capacities` -> `PSConfig.from_plan`). The collection's
`tables` stay on the host for this backend and become the cold tier as
they are (one copy). Pooled output lands on the collection's device.

A port of `repro/storage/tiered.py`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.storage.base import EmbeddingStorage, StorageCapabilities
from repro_torch.storage.registry import register


def _reject_double_remap(cfg, name: str) -> None:
    """Shared tiered/sharded guard: the parameter server owns the hot-first
    permutation (its hot tier); a second collection-level remap would
    double-remap indices."""
    if cfg is not None and cfg.pinned_rows > 0:
        raise ValueError(f"storage={name!r} manages hot rows in the "
                         f"parameter server; set pinned_rows=0 and size "
                         f"the hot tier via PSConfig.hot_rows")


def build_ps_config(trace, rows: int, dim: int, itemsize: int,
                    ps_cfg=None, device_budget_bytes: Optional[int] = None,
                    **overrides):
    """Resolve an explicit `PSConfig` vs the budget-driven auto-tune path.

    Exactly one of the two modes applies; mixing them raises so an explicit
    config can never silently win over budget/override arguments."""
    from repro_torch.ps import PSConfig  # lazy: ps imports core
    if ps_cfg is None:
        if device_budget_bytes is None or trace is None:
            raise ValueError(
                "auto-tuned tiers need both trace= and "
                "device_budget_bytes= (or pass an explicit ps_cfg)")
        from repro_torch.core.plan import plan_tier_capacities
        tier_plan = plan_tier_capacities(trace, rows, dim,
                                         device_budget_bytes,
                                         itemsize=itemsize)
        return PSConfig.from_plan(tier_plan, **overrides)
    if overrides or device_budget_bytes is not None:
        raise ValueError("device_budget_bytes and PSConfig overrides "
                         "only apply when ps_cfg is None (auto-tuning "
                         "path) — the explicit config would silently "
                         "win otherwise")
    return ps_cfg


def _as_numpy(x):
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@register("tiered")
class TieredStorage(EmbeddingStorage):
    """Three-tier beyond-device-memory storage; `lookup()` equals the
    `device` backend bit for bit (f32, sum or unweighted mean)."""

    def __init__(self, ebc, ps=None):
        super().__init__(ebc)
        _reject_double_remap(self.cfg, "tiered")
        self.ps = ps                   # repro_torch.ps.ParameterServer
        self._closed = False

    @classmethod
    def adopt(cls, ps) -> "TieredStorage":
        """Wrap an already-built `ParameterServer` (no collection bound) so
        callers holding a raw PS can talk to protocol-driven code.
        `lookup()` through the collection is unavailable on an adopted
        instance; the serving verbs all work."""
        return cls(None, ps=ps)

    # -- descriptor ---------------------------------------------------------
    def capabilities(self) -> StorageCapabilities:
        # close() drops the server reference entirely, so EVERY serving
        # capability drains after close() and lookup/stage raise a clear
        # "backend closed" error — build() re-opens. Live prefetch depth
        # (not the built config) decides stageability
        stageable = (self.ps is not None
                     and self.ps.prefetch.depth > 0
                     and not getattr(self.ps.prefetch, "closed", False))
        return StorageCapabilities(
            device_resident=False,
            stageable=stageable,
            async_prefetch=stageable and self.ps.cfg.async_prefetch,
            refreshable=True,
            tunable=self.ps is not None,
            degradable=self.ps is not None,
            fused_lookup=self.ps is not None and self.ps.supports_fused(),
            updatable=self.ps is not None)

    # -- construction -------------------------------------------------------
    def build(self, ps_cfg=None, trace: Optional[np.ndarray] = None, *,
              device_budget_bytes: Optional[int] = None,
              **ps_cfg_overrides) -> "TieredStorage":
        """Move the collection's host tables into a tiered ParameterServer.

        `ebc.tables` becomes the host cold tier (authoritative copy, not
        copied); the hot tier is planned from `trace` when given. Pass an
        explicit `ps_cfg`, or leave it None with `device_budget_bytes` set
        to auto-tune tier capacities from the trace's coverage curve
        (`ps_cfg_overrides` then forward to `PSConfig.from_plan`, e.g.
        `async_prefetch=True`, `warm_backing="device"`). The device tiers
        and the pooled output live on the collection's device."""
        from repro_torch.ps import ParameterServer
        cfg = self.cfg
        ps_cfg = build_ps_config(trace, cfg.rows, cfg.dim,
                                 cfg.torch_dtype.itemsize, ps_cfg,
                                 device_budget_bytes, **ps_cfg_overrides)
        tables = self.ebc.tables[:cfg.num_tables]
        # construct BEFORE replacing: a constructor failure (bad trace
        # shape) must leave a live backend serving, and a successful
        # rebuild must not leak the old server's worker thread
        new_ps = ParameterServer(tables, ps_cfg, trace=_as_numpy(trace),
                                 device=self.ebc.device)
        old_ps, self.ps = self.ps, new_ps
        self._closed = False
        if old_ps is not None:
            old_ps.close()
        return self

    def _require_built(self) -> None:
        if self.ps is None:
            if self._closed:
                raise RuntimeError(
                    "storage='tiered' backend is closed (its prefetch "
                    "worker is joined) — build() it again before serving")
            raise RuntimeError(
                f"storage={self.name!r} needs a ParameterServer: call "
                f"ebc.storage.build(ps_cfg) first")

    # -- data path ----------------------------------------------------------
    def lookup(self, indices, weights=None, *,
               pre_remapped: bool = False) -> torch.Tensor:
        """Tiered path: rows come from the parameter server (a host call),
        pooling runs on the server's device exactly as the device backend
        pools, so outputs are bit-identical. The fused path serves when
        the server supports it; the per-row path otherwise."""
        self._require_built()
        idx, w = _as_numpy(indices), _as_numpy(weights)
        if self.ps.supports_fused():
            return self.ps.lookup_fused(idx, w, combine=self.cfg.combine)
        rows = self.ps.lookup(idx)                      # [B, T, L, D]
        return self.ps.pool_rows(rows, w, self.cfg.combine)

    # -- protocol delegation ------------------------------------------------
    def can_stage(self) -> bool:
        return self.ps is not None and self.ps.can_stage()

    def stage(self, next_indices: np.ndarray) -> bool:
        self._require_built()
        return self.ps.stage(next_indices)

    def hint_valid(self, n: int) -> None:
        self._require_built()
        self.ps.hint_valid(n)

    def degraded(self) -> bool:
        return self.ps is not None and self.ps.degraded()

    def set_degraded(self, on: bool) -> bool:
        if self.ps is None:
            return False
        return self.ps.set_degraded(on)

    def refresh_window(self):
        return [] if self.ps is None else list(self.ps.window)

    def plan_refresh(self, window=None):
        self._require_built()
        return self.ps.plan_refresh(window)

    def install_refresh(self, plan) -> dict:
        self._require_built()
        return self.ps.install_refresh(plan)

    def refresh(self) -> dict:
        self._require_built()
        return self.ps.refresh()

    # -- online model updates ------------------------------------------------
    def version(self) -> int:
        return 0 if self.ps is None else self.ps.version()

    def begin_update(self, version: int) -> bool:
        self._require_built()
        return self.ps.begin_update(version)

    def apply_update(self, table: int, rows, values) -> bool:
        self._require_built()
        return self.ps.apply_update(table, rows, values)

    def commit_update(self, version: int) -> dict:
        self._require_built()
        return self.ps.commit_update(version)

    def abort_update(self, version: int) -> bool:
        return False if self.ps is None else self.ps.abort_update(version)

    # -- runtime tuning ------------------------------------------------------
    def prefetch_depth(self) -> int:
        return 0 if self.ps is None else self.ps.prefetch.depth

    def set_prefetch_depth(self, depth: int) -> bool:
        if self.ps is None:
            return False
        self.ps.set_prefetch_depth(depth)
        return True

    def take_prefetch_window_peak(self) -> int:
        return 0 if self.ps is None else self.ps.prefetch.take_window_peak()

    def retune_capacities(self, budget_bytes: int):
        """Re-size hot/warm tiers under a live budget from the sliding
        traffic window (None when the window is empty)."""
        return None if self.ps is None else self.ps.retune(budget_bytes)

    def stats(self) -> dict:
        return {} if self.ps is None else self.ps.stats()

    def reset_stats(self) -> None:
        if self.ps is not None:
            self.ps.reset_stats()

    def flush(self) -> None:
        if self.ps is not None:
            self.ps.flush()

    def close(self) -> None:
        """Join the prefetch worker and DROP the server reference: a
        closed backend must not pass `_require_built` nor advertise
        `tunable` through a dead server. Idempotent; `build()` re-opens."""
        if self.ps is not None:
            self.ps.close()
            self.ps = None
            self._closed = True
