"""Serving layer: the batching loop, the session facade, and the SLO loop.

`ServingSession` is the front door — it owns batcher + engine + storage
and picks its engine from the `repro_torch.storage` backend's
capabilities. `InferenceServer`/`Batcher` remain the inner loop for
callers that wire their own engines.

Controllers compose through ONE spec: `configure(auto_tune=..., slo=...,
updates=...)` -> `ServingControllers`, passed as
`ServingSession(controllers=...)`. The per-controller kwargs
(`auto_tune=`, `slo=`) remain as exact aliases — passing both surfaces at
once is a ValueError. The SLO outer loop (`SLOConfig`/`SLOController`)
escalates widen -> batch-shrink (`min_batch`) -> degraded, with admission
shedding via `BatcherConfig.max_queue`/`deadline_ms` + `QueryShedError`.

The multi-tenant manager of `repro.serving` (`TenantManager`,
`TenantSpec`) comes in a later slice (ROADMAP.md Queue 1 item 11);
`ArbiterConfig`/`BudgetArbiter` are here already for `configure`.
"""
from repro_torch.ps.tuning import (ArbiterConfig, AutoTuneConfig,
                                   BudgetArbiter, QueueDepthController)
from repro_torch.serving.config import (ServingControllers, UpdateConfig,
                                        configure)
from repro_torch.serving.server import (Batcher, BatcherConfig,
                                        InferenceServer, Query,
                                        QueryShedError, ServeStats)
from repro_torch.serving.session import ServingSession
from repro_torch.serving.slo import SLOConfig, SLOController, windowed_p99_ms

__all__ = ["Batcher", "BatcherConfig", "InferenceServer", "Query",
           "QueryShedError", "ServeStats", "ServingSession",
           "AutoTuneConfig", "QueueDepthController", "SLOConfig",
           "SLOController", "windowed_p99_ms", "ServingControllers",
           "UpdateConfig", "configure", "ArbiterConfig", "BudgetArbiter"]
