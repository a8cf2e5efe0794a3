"""Configuration for the tiered embedding parameter server.

The hierarchy generalizes the paper's two placement techniques across the
memory system (HugeCTR HPS-style):

  tier 0 (hot)  — device-resident block of the top-K hottest rows per table,
                  stored hot-first (the paper's L2-pin analogue, §IV-C).
  tier 1 (warm) — fixed-capacity device cache with LFU/LRU admission and
                  eviction over row slots; misses resolve in batches. With
                  `warm_backing="device"` the payload is a tensor on the
                  card updated with `index_copy_`.
  tier 2 (cold) — full tables in host memory (numpy), serving batched
                  gathers for warm misses, fronted by a prefetch queue that
                  resolves the NEXT batch's misses while the current batch
                  computes (the paper's software prefetching, §IV-B,
                  generalized across the hierarchy). With
                  `async_prefetch=True` those gathers run on a background
                  worker thread into a double buffer instead of on the
                  caller thread.

Tier capacities can be hand-set or derived from an offline trace with
`repro_torch.core.plan.plan_tier_capacities` + `PSConfig.from_plan` (the
planner-driven auto-tuning path). A copy of `repro/ps/config.py`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PSConfig:
    # tier 0: rows pinned hot-first per table (0 disables the hot tier)
    hot_rows: int = 0
    # tier 1: warm-cache slots per table (0 disables the warm tier)
    warm_slots: int = 0
    # admission/eviction policy for the warm tier
    eviction: str = "lfu"          # 'lfu' | 'lru'
    # payload backing for the warm tier: 'host' keeps numpy (cheap, exact
    # simulation), 'device' keeps a tensor on the parameter server's
    # device updated with index_copy_ (the deployment shape)
    warm_backing: str = "host"     # 'host' | 'device'
    # prefetch queue depth (staged future batches); 0 disables staging
    prefetch_depth: int = 2
    # resolve staged cold misses on a background worker thread (double
    # buffer) instead of synchronously on the stage() caller
    async_prefetch: bool = False
    # sliding window (in batches, per table) kept for hot-set re-planning
    window_batches: int = 16
    # decay applied to warm-tier frequency counters at refresh (LFU aging)
    freq_decay: float = 0.5
    # fused lookup path: resolve warm hits + pooled reduction in one fused
    # kernel launch over the device-resident payload, emitting a compact
    # miss-list for the host cold path (ParameterServer.lookup_fused).
    # Requires warm_backing='device'; storage backends fall back to the
    # per-row path when off or when the backing is host-side
    fused_lookup: bool = False

    def __post_init__(self):
        if self.eviction not in ("lfu", "lru"):
            raise ValueError(f"eviction must be 'lfu' or 'lru', "
                             f"got {self.eviction!r}")
        if self.warm_backing not in ("host", "device"):
            raise ValueError(f"warm_backing must be 'host' or 'device', "
                             f"got {self.warm_backing!r}")
        if self.hot_rows < 0 or self.warm_slots < 0:
            raise ValueError("tier capacities must be >= 0")
        if self.fused_lookup and self.warm_backing != "device":
            raise ValueError("fused_lookup=True needs the device-resident "
                             "warm payload: set warm_backing='device'")

    @classmethod
    def from_plan(cls, plan, **overrides) -> "PSConfig":
        """Build a config from a `core.plan.TierCapacityPlan` (duck-typed:
        anything with `hot_rows`/`warm_slots`). Keyword overrides pass
        through to the constructor (e.g. `async_prefetch=True`)."""
        return cls(hot_rows=int(plan.hot_rows),
                   warm_slots=int(plan.warm_slots), **overrides)

    def capacity_rows(self) -> int:
        """Device-resident rows per table across hot + warm tiers."""
        return self.hot_rows + self.warm_slots

    def device_bytes(self, num_tables: int, dim: int,
                     itemsize: int = 4) -> int:
        return num_tables * self.capacity_rows() * dim * itemsize
