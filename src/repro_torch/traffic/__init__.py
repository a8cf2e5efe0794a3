"""Traffic subsystem: timestamped query streams + virtual-time replay.

Rate profiles x hotness models compose into deterministic DLRM traces
(`generators`), a `VirtualClock` puts the serving loop on trace time
(`clock`), and `replay()` drives a `ServingSession` through a stream
while recording an overload timeline (`replay`); `replay_tenants()`
drives a `TenantManager`'s per-tenant streams on its one clock.
"""
from repro_torch.traffic.clock import VirtualClock
from repro_torch.traffic.generators import (TRACE_KINDS, DiurnalRate,
                                            FlashCrowdRate, SteadyRate,
                                            TimedQuery, TrafficGenerator,
                                            make_traffic)
from repro_torch.traffic.replay import (ReplayReport, ReplaySnapshot, replay,
                                        replay_tenants)

__all__ = ["VirtualClock", "TimedQuery", "TrafficGenerator", "make_traffic",
           "SteadyRate", "DiurnalRate", "FlashCrowdRate", "TRACE_KINDS",
           "ReplayReport", "ReplaySnapshot", "replay", "replay_tenants"]
