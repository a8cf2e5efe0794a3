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
  `require_capability`  — fail fast when a backend lacks a capability.

The `sharded` and `pool` backends of `repro.storage` come in later slices
(ROADMAP.md Queue 1).
"""
from repro_torch.storage.base import (CapabilityError, EmbeddingStorage,
                                      StorageCapabilities,
                                      require_capability)
from repro_torch.storage.registry import (UnknownBackendError, available,
                                          create, register, resolve,
                                          unregister)
# importing a backend module registers it
from repro_torch.storage.device import DeviceStorage
from repro_torch.storage.tiered import TieredStorage

__all__ = ["CapabilityError", "EmbeddingStorage", "StorageCapabilities",
           "require_capability", "UnknownBackendError", "available",
           "create", "register", "resolve", "unregister", "DeviceStorage",
           "TieredStorage"]
