"""Traffic subsystem: timestamped query streams + virtual-time replay.

Rate profiles x hotness models compose into deterministic DLRM traces
(`generators`), a `VirtualClock` puts the serving loop on trace time
(`clock`), and `replay()` drives a `ServingSession` through a stream
while recording an overload timeline (`replay`). The multi-tenant
`replay_tenants` of `repro.traffic` comes with the tenant manager
(ROADMAP.md Queue 1 item 11).
"""
from repro_torch.traffic.clock import VirtualClock
from repro_torch.traffic.generators import (TRACE_KINDS, DiurnalRate,
                                            FlashCrowdRate, SteadyRate,
                                            TimedQuery, TrafficGenerator,
                                            make_traffic)
from repro_torch.traffic.replay import ReplayReport, ReplaySnapshot, replay

__all__ = ["VirtualClock", "TimedQuery", "TrafficGenerator", "make_traffic",
           "SteadyRate", "DiurnalRate", "FlashCrowdRate", "TRACE_KINDS",
           "ReplayReport", "ReplaySnapshot", "replay"]
