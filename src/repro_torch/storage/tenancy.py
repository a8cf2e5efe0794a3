"""Tenant-scoped views over one shared storage backend.

Multi-tenant serving (HugeCTR's inference parameter server shape, arxiv
2210.08804: many models served from ONE shared cache hierarchy) needs the
storage protocol keyed by tenant: each model owns a contiguous slice of
the shared backend's table axis, looks up / stages / refreshes against
THAT slice only, and reads stats scoped to its own units — while hot/warm
capacity and prefetch depth stay one shared pool arbitrated across
tenants (`repro_torch.ps.tuning.BudgetArbiter`).

Two pieces live here:

  `TenantNamespace` — one tenant's slice of the shared table axis:
      global table id `t` belongs to the tenant iff start <= t < stop,
      and its tenant-local column is `t - start`. Contiguity is load-
      bearing: the pool backend serves contiguous table runs as zero-copy
      views into the shared host segment, and a tenant's tables staying
      contiguous keeps that true per tenant.

  `TenantStorage` — a full `EmbeddingStorage` facade over one tenant's
      slice. It binds to the TENANT model's collection (tenant-local
      geometry), so `ServingSession` and every generic caller work
      completely unchanged — they cannot tell a tenant view from a
      whole backend. Every verb delegates to the shared backend's
      `tenant_*` methods (sharded/pool implement them); `close()` is a
      deliberate no-op because the tenant does NOT own the shared
      backend — the `TenantManager` does.

Migration is intentionally absent from tenant views: re-placing tables
mid-serving is a whole-backend decision, and under tenancy the live
fairness mechanism is the arbiter (capacity + depth re-splits), not
placement moves — `plan_migration` returns None by contract.

A port of `repro/storage/tenancy.py`; the verbs take no params (the port's
backends read their collection's tables).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.storage.base import EmbeddingStorage, StorageCapabilities


@dataclasses.dataclass(frozen=True)
class TenantNamespace:
    """One tenant's contiguous slice [start, stop) of the shared table
    axis. `stop - start` is the tenant's table count; tenant-local column
    of global table `t` is `t - start`."""
    name: str
    start: int
    stop: int

    @property
    def num_tables(self) -> int:
        return self.stop - self.start

    def owns(self, table: int) -> bool:
        return self.start <= table < self.stop

    def local(self, table_ids: np.ndarray) -> np.ndarray:
        """Global table ids -> tenant-local columns."""
        return np.asarray(table_ids, np.int64) - self.start


def resolve_tenants(tenants: dict, num_tables: int) -> dict:
    """Turn a `tenants={name: table_count}` build argument into contiguous
    `TenantNamespace`s (declaration order fixes the layout). The counts
    must tile the shared table axis exactly — a gap would orphan tables,
    an overlap would double-serve them."""
    if not tenants:
        raise ValueError("tenants= needs at least one {name: table_count}")
    spaces: dict[str, TenantNamespace] = {}
    start = 0
    for name, count in tenants.items():
        count = int(count)
        if count < 1:
            raise ValueError(f"tenant {name!r} needs >= 1 table, "
                             f"got {count}")
        spaces[str(name)] = TenantNamespace(str(name), start, start + count)
        start += count
    if start != num_tables:
        raise ValueError(
            f"tenant table counts sum to {start} but the collection has "
            f"{num_tables} tables — tenants= must tile the table axis")
    return spaces


class TenantStorage(EmbeddingStorage):
    """One tenant's `EmbeddingStorage` facade over a shared backend.

    Bound to the tenant model's own collection, so `self.cfg` describes
    the TENANT-LOCAL geometry ([T_tenant, R, D]) and `lookup()` takes
    tenant-local [B, T_tenant, L] indices. All state lives in the shared
    backend; the view is a stateless router keyed by tenant name.
    """

    name = "tenant-view"

    def __init__(self, shared, tenant: str, ebc=None):
        super().__init__(ebc)
        self.shared = shared
        self.tenant = str(tenant)

    # -- descriptor ---------------------------------------------------------
    def capabilities(self) -> StorageCapabilities:
        caps = self.shared.capabilities()
        # migration is whole-backend; under tenancy the arbiter (not
        # placement moves) is the live fairness mechanism
        return dataclasses.replace(caps, migratable=False)

    def build(self, **kwargs) -> "TenantStorage":
        raise RuntimeError(
            "a tenant view serves an already-built shared backend; build "
            "the shared storage once (with tenants={...}) and attach "
            "tenants through TenantManager")

    # -- data path ----------------------------------------------------------
    def lookup(self, indices, weights=None, *,
               pre_remapped: bool = False):
        return self.shared.tenant_lookup(self.tenant, indices, weights)

    def can_stage(self) -> bool:
        return self.shared.tenant_can_stage(self.tenant)

    def stage(self, next_indices: np.ndarray) -> bool:
        return self.shared.tenant_stage(self.tenant, next_indices)

    def hint_valid(self, n: int) -> None:
        self.shared.tenant_hint_valid(self.tenant, n)

    # -- refresh ------------------------------------------------------------
    def refresh_window(self) -> Any:
        return self.shared.tenant_refresh_window(self.tenant)

    def plan_refresh(self, window: Any = None) -> Any:
        return self.shared.tenant_plan_refresh(self.tenant, window)

    def install_refresh(self, plan: Any) -> dict:
        return self.shared.tenant_install_refresh(self.tenant, plan)

    def refresh(self) -> dict:
        return self.install_refresh(self.plan_refresh(self.refresh_window()))

    # -- runtime tuning ------------------------------------------------------
    def prefetch_depth(self) -> int:
        return self.shared.tenant_prefetch_depth(self.tenant)

    def set_prefetch_depth(self, depth: int) -> bool:
        return self.shared.tenant_set_prefetch_depth(self.tenant, depth)

    def take_prefetch_window_peak(self) -> int:
        return self.shared.tenant_take_prefetch_window_peak(self.tenant)

    def retune_capacities(self, budget_bytes: int) -> Optional[dict]:
        return self.shared.tenant_retune_capacities(self.tenant,
                                                    budget_bytes)

    def device_bytes(self) -> int:
        """Device-resident cache bytes (hot block + warm payload) held by
        THIS tenant's units — what the arbiter's budget conservation
        invariant sums."""
        return self.shared.tenant_device_bytes(self.tenant)

    # -- degraded mode -------------------------------------------------------
    def degraded(self) -> bool:
        return self.shared.tenant_degraded(self.tenant)

    def set_degraded(self, on: bool) -> bool:
        return self.shared.tenant_set_degraded(self.tenant, on)

    # -- online model updates -------------------------------------------------
    # tenant-scoped: table ids are TENANT-LOCAL, the version counter is
    # this tenant's own — tenants upgrade independently and a sibling's
    # units are never touched
    def version(self) -> int:
        return self.shared.tenant_version(self.tenant)

    def begin_update(self, version: int) -> bool:
        return self.shared.tenant_begin_update(self.tenant, version)

    def apply_update(self, table: int, rows, values) -> bool:
        return self.shared.tenant_apply_update(self.tenant, table, rows,
                                               values)

    def commit_update(self, version: int) -> dict:
        return self.shared.tenant_commit_update(self.tenant, version)

    def abort_update(self, version: int) -> bool:
        return self.shared.tenant_abort_update(self.tenant, version)

    # -- placement -----------------------------------------------------------
    def update_routing(self) -> Optional[dict]:
        # replica routing is per-table, so the global fold is tenant-safe
        return self.shared.update_routing()

    # plan_migration/install_migration: inherited inert defaults (None /
    # {'migrated': False}) — see the module docstring.

    # -- stats & hygiene ----------------------------------------------------
    def stats(self) -> dict:
        return self.shared.tenant_stats(self.tenant)

    def reset_stats(self) -> None:
        self.shared.tenant_reset_stats(self.tenant)

    def flush(self) -> None:
        self.shared.tenant_flush(self.tenant)

    def close(self) -> None:
        """Deliberate no-op: the shared backend outlives any one tenant
        (the TenantManager owns its lifecycle). `detach_tenant` on the
        shared backend is the verb that actually releases a tenant."""

    def __repr__(self) -> str:
        return (f"<TenantStorage tenant={self.tenant!r} "
                f"over {type(self.shared).__name__}>")
