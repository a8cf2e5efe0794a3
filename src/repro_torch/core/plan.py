"""Static profiling framework (paper §VII) — decide which knobs to apply —
and tier-capacity planning for the tiered parameter server (the same
recipe applied to the memory hierarchy).

The paper's recipe in H100 terms:
 (i)   memory-latency bound?   -> hotness metrics + arithmetic intensity
 (ii)  occupancy maximal?      -> bags (warps) per thread block
 (iii) OptMT                   -> ring depth and bags per block within
                                  shared memory
 (iv)  still latency bound?    -> enable prefetching (ring depth)
 (v)   high-reuse region?      -> pin top-K rows in L2 (coverage threshold)
 (vi)  bandwidth headroom?     -> deepen the ring
 (vii) combine both

The port holds `repro/core/plan.py` whole but for its TPU budgets:
`EmbeddingPlanReport` and `plan_embedding_stage` size the pinned rows
against the H100's L2 (`hot_cache.l2_budget_rows`) where the TPU path
sized them against VMEM; `TierCapacityPlan`, `plan_tier_capacities`,
`AdmissionPlan` and `plan_admission` (numpy, copied);
`estimate_device_budget`, which reads the card's free memory from
`torch.cuda.mem_get_info` where the TPU path read the runtime's memory
stats; and the shard planners `plan_shard_placement` and
`plan_shard_migration`, thin delegations into `storage.placement`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import access_patterns as ap
from repro_torch.core.hot_cache import l2_budget_rows
from repro_torch.kernels.embedding_bag.kernel import (RING_DEPTHS,
                                                      LaunchGeometry)


@dataclasses.dataclass(frozen=True)
class EmbeddingPlanReport:
    """The kernel knobs `plan_embedding_stage` picked for one table.

    The fields the TPU path's report shares keep their names and rules.
    Its `vmem_bytes` (pinned rows, pipeline and output blocks in one
    core's VMEM) has no counterpart on the card, where those live in
    different memories: `l2_pinned_bytes` is what the pinned rows take of
    the L2 budget, and `shared_memory_bytes` what one thread block of the
    kernel takes at this ring depth and bags per block."""

    hotness_unique_pct: float
    hot_coverage_at_k: float      # fraction of accesses served by pinned rows
    pinned_rows: int
    prefetch_distance: int
    batch_block: int
    l2_pinned_bytes: int
    shared_memory_bytes: int
    latency_bound: bool
    notes: tuple[str, ...]


def plan_embedding_stage(trace: np.ndarray, num_rows: int, dim: int,
                         itemsize: int = 4,
                         target_coverage: float = 0.5) -> EmbeddingPlanReport:
    """Given an offline index trace for one table, pick the kernel knobs.

    The rules are the TPU path's: the smallest K whose rows cover
    `target_coverage` of the accesses, dropped below 10 % coverage; a ring
    of ceil(16 · cold fraction) rows. The budgets are the H100's: K is
    clamped to the rows the L2 budget holds (`l2_budget_rows`), and the
    distance to the ring depths the kernel takes (`RING_DEPTHS`; the kernel
    itself rounds it down to a power of two).
    """
    notes = []
    uniq = ap.unique_access_pct(trace, num_rows)
    counts = np.bincount(trace.reshape(-1), minlength=num_rows)
    order = np.argsort(-counts)
    csum = np.cumsum(counts[order]) / max(1, trace.size)

    # (i) latency bound: gather of one row (dim*itemsize bytes) per 2*dim flops
    # -> arithmetic intensity ~ 2/itemsize flop/byte << ridge; always true.
    latency_bound = True

    # (v) pinning: smallest K reaching target coverage, clamped to L2 budget.
    budget_rows = l2_budget_rows(dim, itemsize)
    k_cov = int(np.searchsorted(csum, target_coverage) + 1)
    if csum[-1] < target_coverage:
        k_cov = num_rows
    pinned = int(min(k_cov, budget_rows, num_rows))
    coverage = float(csum[pinned - 1]) if pinned > 0 else 0.0
    if coverage < 0.10:
        notes.append("low reuse: pinning covers <10% of accesses; disabled")
        pinned, coverage = 0, 0.0

    # (iii/iv/vi) ring: deeper when the cold fraction is high. A row wider
    # than a ring slot is pooled in passes over the same ring, so the width
    # bounds nothing here (the TPU path capped its row buffer at 1 MiB).
    cold_frac = 1.0 - coverage
    distance = int(np.clip(np.ceil(16 * cold_frac), *RING_DEPTHS))

    batch_block = 8
    geometry = LaunchGeometry(prefetch_distance=distance,
                              batch_block=batch_block)
    return EmbeddingPlanReport(
        hotness_unique_pct=uniq, hot_coverage_at_k=coverage,
        pinned_rows=pinned, prefetch_distance=distance,
        batch_block=batch_block,
        l2_pinned_bytes=pinned * dim * itemsize,
        shared_memory_bytes=geometry.shared_bytes(dim, itemsize),
        latency_bound=latency_bound, notes=tuple(notes))


@dataclasses.dataclass(frozen=True)
class TierCapacityPlan:
    """Planned per-table hot/warm capacities under a device-byte budget.

    Feed into `repro_torch.ps.PSConfig.from_plan(plan)`. Coverages are measured
    on the planning trace: `hot_coverage` is exact for a statically pinned
    hot tier; `total_coverage` is the upper bound a perfectly-adaptive warm
    tier of `warm_slots` would add on top (the LFU/LRU cache approaches it
    from below).
    """

    hot_rows: int                 # tier-0 capacity per table
    warm_slots: int               # tier-1 capacity per table
    hot_coverage: float           # trace accesses served by the hot tier
    total_coverage: float         # upper bound with hot + warm resident
    budget_bytes: int             # requested device budget (all tables)
    used_bytes: int               # bytes the planned tiers actually consume
    budget_rows: int              # per-table row budget the bytes allow
    notes: tuple[str, ...]


def plan_tier_capacities(trace: np.ndarray, num_rows: int, dim: int,
                         budget_bytes: int, *, itemsize: int = 4,
                         hot_coverage_target: float = 0.6,
                         min_hot_count: int = 2) -> TierCapacityPlan:
    """Size the hot/warm tiers from a trace's coverage curve under a byte
    budget (the §VII profiling recipe applied to the memory hierarchy).

    trace: [N, T, L] (or [N, L] for a single table) raw row ids — the same
    offline window `ParameterServer(trace=...)` plans the hot set from.

    Split rule: the hot tier gets the head of the (table-averaged) coverage
    curve — rows that are both frequent enough to stay hot between
    refreshes (average count >= `min_hot_count`) and within the knee up to
    `hot_coverage_target` cumulative coverage; everything else in the
    budget goes to warm slots, whose LFU/LRU admission catches the mobile
    middle of the distribution. Rows the budget cannot hold stay cold.

    Monotone in the budget: growing `budget_bytes` never shrinks
    `hot_rows`, `warm_slots`, or their sum (the auto-tuner can sweep
    budgets and trust the ordering).
    """
    notes = []
    trace = np.asarray(trace)
    if trace.ndim == 2:
        trace = trace[:, None, :]
    assert trace.ndim == 3, "expected trace [N, T, L]"
    T = trace.shape[1]

    # Table-averaged sorted-count curve: position k holds the mean count of
    # each table's k-th hottest row (capacities are uniform across tables).
    curves = np.stack(
        [np.sort(np.bincount(trace[:, t].reshape(-1),
                             minlength=num_rows))[::-1]
         for t in range(T)]).astype(np.float64)
    mean_counts = curves.mean(axis=0)                     # [R], descending
    total = mean_counts.sum()
    coverage = (np.cumsum(mean_counts) / total if total > 0
                else np.zeros(num_rows))

    row_bytes = dim * itemsize
    budget_rows = int(max(0, budget_bytes) // (T * row_bytes))
    capacity = int(min(budget_rows, num_rows))
    if capacity == 0:
        notes.append("budget below one row per table; all tiers cold")

    # Hot cut, independent of the budget (=> monotonicity): frequent enough
    # to pin AND inside the target-coverage head of the curve.
    k_freq = int(np.searchsorted(-mean_counts, -float(min_hot_count),
                                 side="right"))
    k_cov = int(np.searchsorted(coverage, hot_coverage_target) + 1)
    k_cov = min(k_cov, num_rows)
    k_star = min(k_freq, k_cov)
    if k_star == 0:
        notes.append("no row recurs in the trace; hot tier disabled")
    elif k_star < k_cov:
        notes.append(f"min_hot_count caps the hot set before the "
                     f"{hot_coverage_target:.0%} coverage target (flat "
                     f"curve); the warm tier carries the difference")

    hot = min(k_star, capacity)
    warm = capacity - hot
    if hot < k_star:
        notes.append(f"budget truncates hot set ({hot} of {k_star} rows)")

    hot_cov = float(coverage[hot - 1]) if hot > 0 else 0.0
    total_cov = float(coverage[capacity - 1]) if capacity > 0 else 0.0
    return TierCapacityPlan(
        hot_rows=hot, warm_slots=warm, hot_coverage=hot_cov,
        total_coverage=total_cov, budget_bytes=int(budget_bytes),
        used_bytes=T * capacity * row_bytes, budget_rows=budget_rows,
        notes=tuple(notes))


def estimate_device_budget(fraction: float = 0.5,
                           fallback_bytes: int | None = None,
                           device=None) -> int | None:
    """LIVE device-byte budget for tier planning: the card's free memory
    (`torch.cuda.mem_get_info`) scaled by `fraction` headroom. Without a
    card (a CPU device, or no CUDA at all) it returns `fallback_bytes` —
    None there means "no estimate", and callers (the serving auto-tuner)
    skip the capacity step rather than guessing.
    """
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") \
            or not torch.cuda.is_available():
        return fallback_bytes
    free, _total = torch.cuda.mem_get_info(dev)
    return int(max(0, free) * fraction)


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """Planned admission knobs for `serving.BatcherConfig` under a p99 SLO.

    The wait a query sees is roughly (batches ahead of it) x (batch
    service time), so the queue length at which predicted wait crosses the
    latency budget is the natural shed point. `deadline_ms` is the budget
    the batcher's deadline predictor enforces; `max_queue` is the hard cap
    equivalent (same crossing point, enforced without a service-time
    estimate), usable as a belt-and-braces bound or on its own before the
    service EWMA has warmed up.
    """

    deadline_ms: float            # BatcherConfig.deadline_ms
    max_queue: int                # BatcherConfig.max_queue
    batches_in_budget: int        # whole batches servable inside the budget
    sustainable_qps: float        # max_batch / batch_service: shed-free rate
    notes: tuple[str, ...]


def plan_admission(target_p99_ms: float, batch_service_ms: float,
                   max_batch: int, *,
                   headroom: float = 0.8) -> AdmissionPlan:
    """Size admission control from a latency target and a measured batch
    service time (the §VII recipe applied to the serving queue).

    `headroom` shrinks the budget below the raw target so that batching-
    window waits and service-time jitter land inside the SLO rather than
    on it: `deadline_ms = target * headroom`. With B = budget // service
    whole batches servable in the budget, a query admitted behind more
    than B-1 full batches would finish late, so `max_queue = B *
    max_batch` (at least one batch — admission never blocks an idle
    server).
    """
    if target_p99_ms <= 0:
        raise ValueError("target_p99_ms must be positive")
    if batch_service_ms <= 0:
        raise ValueError("batch_service_ms must be positive")
    if max_batch <= 0:
        raise ValueError("max_batch must be positive")
    if not (0.0 < headroom <= 1.0):
        raise ValueError("headroom must be in (0, 1]")
    notes = []
    deadline_ms = target_p99_ms * headroom
    batches = int(deadline_ms // batch_service_ms)
    if batches < 1:
        notes.append("budget below one batch service time; queue capped "
                     "at a single batch (every queued query is late)")
        batches = 1
    return AdmissionPlan(
        deadline_ms=float(deadline_ms), max_queue=int(batches * max_batch),
        batches_in_budget=batches,
        sustainable_qps=float(max_batch / batch_service_ms * 1e3),
        notes=tuple(notes))


# ---------------------------------------------------------------------------
# Table-to-shard placement planning (frequency-aware load balancing)
# ---------------------------------------------------------------------------

def plan_shard_placement(trace: np.ndarray, num_shards: int, **kwargs):
    """Planner-API entry for frequency-aware table-to-shard balancing:
    per-table load = unique-access rate x row bytes, assigned by greedy LPT
    with an optional hot-table replication escape hatch. Returns a
    `repro_torch.storage.placement.ShardPlacement` for
    `ShardedStorage.build(placement=...)`; see that module for the model.

    Thin delegation (lazy import: `repro_torch.storage` imports back into
    core) so every planning entry point — tier capacities, admission,
    shard placement — lives on one surface.
    """
    from repro_torch.storage.placement import plan_shard_placement as _plan
    return _plan(trace, num_shards, **kwargs)


def plan_shard_migration(old_placement, trace: np.ndarray, **kwargs):
    """Planner-API entry for OFFLINE migration what-if analysis: re-cost a
    serving `ShardPlacement` under a fresh traffic trace and return a
    `repro_torch.storage.placement.MigrationPlan` (which tables move,
    imbalance before/after) — or None when the placement still holds up.
    The live path is `ShardedStorage.plan_migration()`/
    `install_migration()` (driven by `ServingSession(auto_tune=...)`);
    this entry lets capacity planning ask the same question from a
    recorded trace without a built backend. Same thin-delegation
    rationale as `plan_shard_placement`.
    """
    from repro_torch.storage.placement import plan_migration as _plan
    return _plan(old_placement, trace, **kwargs)
