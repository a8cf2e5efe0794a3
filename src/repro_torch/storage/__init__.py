"""Pluggable embedding-storage backends behind one protocol.

Public surface:
  `EmbeddingStorage`    — the backend protocol (lookup / update verbs /
                          stats + `StorageCapabilities`).
  `register` / `available` / `resolve` / `create`
                        — the string-keyed backend registry
                          (`EmbeddingStageConfig.storage` resolves here).
  `DeviceStorage`       — `"device"`: tables resident in device memory,
                          pooled by the CUDA embedding-bag kernel.
  `TieredStorage`       — `"tiered"`: the hot/warm/cold parameter server,
                          host cold tier, warm payload and hot block on the
                          card, hits pooled by the fused lookup kernel.
  `ShardedStorage`      — `"sharded"`: table-wise partition of the tiered
                          store across shard workers (one ParameterServer
                          a placement unit), merged stats, live routing
                          and migration, and multi-tenant mode.
  `ShardPlacement` / `plan_shard_placement` / `estimate_table_loads`
                        — frequency-aware table-to-shard assignment (LPT
                          balancing + replication escape hatch).
  `MigrationPlan` / `plan_migration` / `ReplicaRouter`
                        — live placement: traffic-drift migration planning
                          (applied build-before-teardown by the sharded
                          backend) and cost-proportional replica routing.
  `TenantNamespace` / `TenantStorage`
                        — multi-tenant mode: contiguous per-tenant table
                          namespaces over ONE shared sharded backend
                          (`build(..., tenants={name: count})`) and the
                          per-tenant `EmbeddingStorage` facade that
                          `ServingSession` binds to, unchanged.
  `PoolStorage`         — `"pool"`: the sharded store's units served by
                          worker processes (each with its own CUDA
                          context) over one shared host cold tier; typed
                          `WorkerDeadError` / `RemoteCallError`.
  `require_capability`  — fail fast when a backend lacks a capability.
"""
from repro_torch.storage.base import (CapabilityError, EmbeddingStorage,
                                      StorageCapabilities,
                                      require_capability)
from repro_torch.storage.placement import (MigrationPlan, ReplicaRouter,
                                           ShardPlacement,
                                           estimate_table_loads,
                                           plan_migration,
                                           plan_shard_placement)
from repro_torch.storage.registry import (UnknownBackendError, available,
                                          create, register, resolve,
                                          unregister)
from repro_torch.storage.tenancy import TenantNamespace, TenantStorage
# importing a backend module registers it
from repro_torch.storage.device import DeviceStorage
from repro_torch.storage.tiered import TieredStorage
from repro_torch.storage.sharded import ShardedStorage
from repro_torch.storage.pool import (PoolStorage, RemoteCallError,
                                      WorkerDeadError)

__all__ = ["CapabilityError", "EmbeddingStorage", "StorageCapabilities",
           "require_capability", "UnknownBackendError", "available",
           "create", "register", "resolve", "unregister", "DeviceStorage",
           "TieredStorage", "ShardedStorage", "ShardPlacement",
           "estimate_table_loads", "plan_shard_placement", "MigrationPlan",
           "ReplicaRouter", "plan_migration", "TenantNamespace",
           "TenantStorage", "PoolStorage", "RemoteCallError",
           "WorkerDeadError"]
