"""Tiered embedding parameter server (hot / warm / cold) for beyond-HBM
DLRM serving — a port of `repro.ps`.

Public surface:
  `ParameterServer` — three-tier, bit-exact `lookup()`, and `lookup_fused()`
                      through the CUDA fused warm-cache kernel; sync or
                      async (threaded, double-buffered) prefetch staging.
  `PSConfig`        — tier capacities + policies; `from_plan()` accepts a
                      `repro_torch.core.plan.plan_tier_capacities` result.
  `WarmCache` / `DeviceWarmCache` — host- and device-backed warm tiers.
  `PrefetchQueue` / `AsyncPrefetcher` — the two staging engines.
  `AutoTuneConfig` / `AutoTuner` / `QueueDepthController`
                    — runtime queue-depth and tier-capacity tuning
                      (`ps.tuning`), driven by `ServingSession`.
"""
from repro_torch.ps.cold_store import ColdStore
from repro_torch.ps.config import PSConfig
from repro_torch.ps.prefetch import AsyncPrefetcher, PrefetchQueue, StagedBatch
from repro_torch.ps.server import ParameterServer
from repro_torch.ps.tuning import (AutoTuneConfig, AutoTuner,
                                   QueueDepthController)
from repro_torch.ps.warm_cache import DeviceWarmCache, WarmCache

__all__ = ["ColdStore", "PSConfig", "AsyncPrefetcher", "PrefetchQueue",
           "StagedBatch", "ParameterServer", "DeviceWarmCache", "WarmCache",
           "AutoTuneConfig", "AutoTuner", "QueueDepthController"]
