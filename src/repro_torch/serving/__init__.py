"""Serving layer: the batching loop and the session facade.

`ServingSession` is the front door — it owns batcher + engine + storage
and picks its engine from the `repro_torch.storage` backend's capabilities.
`InferenceServer`/`Batcher` remain the inner loop for callers that wire
their own engines. The SLO loop, controller spec and multi-tenant manager
of `repro.serving` come in later slices (ROADMAP.md Queue 1).
"""
from repro_torch.serving.server import (Batcher, BatcherConfig,
                                        InferenceServer, Query,
                                        QueryShedError, ServeStats)
from repro_torch.serving.session import ServingSession

__all__ = ["Batcher", "BatcherConfig", "InferenceServer", "Query",
           "QueryShedError", "ServeStats", "ServingSession"]
