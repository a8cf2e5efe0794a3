"""Pluggable embedding-storage backends behind one protocol.

Public surface:
  `EmbeddingStorage`    — the backend protocol (lookup / update verbs /
                          stats + `StorageCapabilities`).
  `register` / `available` / `resolve` / `create`
                        — the string-keyed backend registry
                          (`EmbeddingStageConfig.storage` resolves here).
  `DeviceStorage`       — `"device"`: tables resident in device memory,
                          pooled by the CUDA embedding-bag kernel.

The `tiered`, `sharded` and `pool` backends of `repro.storage` come in
later slices (ROADMAP.md Queue 1).
"""
from repro_torch.storage.base import EmbeddingStorage, StorageCapabilities
from repro_torch.storage.registry import (UnknownBackendError, available,
                                          create, register, resolve,
                                          unregister)
# importing the backend module registers it
from repro_torch.storage.device import DeviceStorage

__all__ = ["EmbeddingStorage", "StorageCapabilities", "UnknownBackendError",
           "available", "create", "register", "resolve", "unregister",
           "DeviceStorage"]
