"""Runtime auto-tuners for the serving loop (the §VII recipe, made live).

Static planning (`core.plan`) picks knobs from an OFFLINE trace; serving
traffic drifts. Two controllers close the loop at runtime, both driven
purely through `EmbeddingStorage` protocol verbs so any tunable backend
(`tiered`) participates and `device` stays inert:

  queue depth    — `QueueDepthController` watches the async prefetcher's
                   `consume_overlap_frac` (how often the consumer found its
                   double buffer already resolved) over a sliding window
                   and widens the bounded buffer when the consumer keeps
                   waiting, narrows it when the extra slots sit unused.
                   Bounded by [min_depth, max_depth] and hysteretic
                   (a dead band between the two thresholds), so it
                   converges instead of oscillating.
  tier capacity  — every `capacity_every_batches` executed batches the
                   session feeds `plan_tier_capacities` a LIVE device-
                   budget estimate (`core.plan.estimate_device_budget`:
                   the card's free memory x fraction, with a static
                   fallback where there is no card) and the backend
                   re-sizes hot/warm tiers from its sliding traffic window
                   (`storage.retune_capacities`).

Two more controllers make the PLACEMENT itself live, for backends that
report the `migratable` capability (a sharded backend, ROADMAP.md Queue 1
item 9; `device` and `tiered` stay inert):

  replica routing — every `route_every_batches` executed batches
                   `storage.update_routing()` folds the window's observed
                   per-replica service costs into each replicated table's
                   `ReplicaRouter`, shifting batch slices away from slow
                   or contended replicas (equal slices until the first
                   observation).
  live migration — every `migrate_every_batches` executed batches
                   `storage.plan_migration()` re-plans table placement
                   from the live traffic window; past the imbalance
                   threshold, `storage.install_migration()` swaps the new
                   placement in build-before-teardown (a failed or
                   rejected migration always leaves the old units
                   serving).

`ServingSession(auto_tune=AutoTuneConfig(...))` drives all four.

Under multi-tenant serving one more controller sits ABOVE the per-tenant
sessions: the `BudgetArbiter` (driven by a tenant manager, ROADMAP.md
Queue 1 item 11; here already so `configure(arbiter=...)` takes it). It
generalizes the capacity leg across tenants sharing ONE backend: every
`every_batches` executed batches it turns each tenant's live access-count
delta into a demand share (floored at `min_share` so an idle tenant is
never starved to zero, then normalized so the shares sum to one), splits
the live device-budget estimate by those shares, and retunes each
tenant's hot/warm capacities — so Σ tenant budgets never exceeds the one
shared budget. Optionally it also re-splits prefetch depth by the same
shares, skipping tenants whose SLO controller is currently engaged (the
breach handler owns that knob during a breach, exactly like
`depth_suspended` above).

A port of `repro/ps/tuning.py`: the same observations give the same
decisions; only the budget estimate reads the card
(`torch.cuda.mem_get_info`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class QueueDepthController:
    """Hysteresis controller for the prefetch bounded-buffer depth.

    `propose()` is a pure function of one observation window:

      overlap_frac   — consume_ready / (consume_ready + consume_waited)
                       over the window (None when nothing was consumed).
      peak_depth     — max queue occupancy seen in the window.
      depth          — the currently configured bound.

    Policy: overlap below `widen_below` means the consumer kept reaching a
    buffer the worker had not finished — give the worker more lead time
    (+`step`). Overlap at/above `narrow_above` while the queue never even
    filled the current bound means slots are dead weight — reclaim one.
    Anything in between (or an idle window) holds. The proposal is always
    clamped to [min_depth, max_depth], so the depth can NEVER leave the
    bound, and the dead band guarantees convergence: once inside it, the
    depth is a fixed point.
    """

    min_depth: int = 1
    max_depth: int = 8
    widen_below: float = 0.5
    narrow_above: float = 0.95
    step: int = 1

    def __post_init__(self):
        if not (1 <= self.min_depth <= self.max_depth):
            raise ValueError("need 1 <= min_depth <= max_depth")
        if not (0.0 <= self.widen_below <= self.narrow_above <= 1.0):
            raise ValueError("need 0 <= widen_below <= narrow_above <= 1")

    def clamp(self, depth: int) -> int:
        return max(self.min_depth, min(self.max_depth, int(depth)))

    def propose(self, depth: int, overlap_frac: Optional[float],
                peak_depth: int) -> int:
        if overlap_frac is None:        # idle window: nothing to learn,
            return depth                # nothing to change (no clamping)
        depth = self.clamp(depth)
        if overlap_frac < self.widen_below:
            return self.clamp(depth + self.step)
        if overlap_frac >= self.narrow_above and peak_depth < depth:
            return self.clamp(depth - 1)
        return depth


@dataclasses.dataclass(frozen=True)
class AutoTuneConfig:
    """What the `ServingSession` auto-tune loop does and how often.

    Either interval set to 0 disables that controller; the default tunes
    queue depth every 8 executed batches and leaves capacity retuning off
    (it drops warm-cache contents when capacities move, so opt in).
    """

    # re-evaluate the prefetch queue depth every N executed batches
    depth_every_batches: int = 8
    controller: QueueDepthController = dataclasses.field(
        default_factory=QueueDepthController)
    # feed plan_tier_capacities a live budget every N executed batches
    # (0 = off)
    capacity_every_batches: int = 0
    # fraction of the estimated free device bytes handed to the planner
    budget_fraction: float = 0.5
    # used when the runtime exposes no memory stats (CPU backends); None
    # skips the capacity step entirely in that case
    budget_fallback_bytes: Optional[int] = None
    # re-split replicated tables' batch slices from observed per-replica
    # service cost every N executed batches (0 = off; `migratable`
    # backends only — a routing move flushes staged prefetch batches)
    route_every_batches: int = 0
    # re-plan table placement from the live traffic window every N
    # executed batches and swap it in when the imbalance threshold is
    # crossed (0 = off; the swap drops the old units' warm caches, so
    # opt in like capacity retuning)
    migrate_every_batches: int = 0
    # live imbalance ratio that triggers a migration; None defers to the
    # backend's build-time `migration_threshold` (or its default)
    migrate_threshold: Optional[float] = None


class AutoTuner:
    """Per-session tuning state: windowed counter deltas + action log.

    `step(storage)` is called by the session after every executed batch;
    it reads `storage.stats()` at each interval boundary, computes the
    window's overlap observation from counter deltas, and applies the
    controller's proposal through the protocol verbs. All decisions are
    recorded in `self.events` (benchmarks/tests introspect them).
    """

    def __init__(self, cfg: AutoTuneConfig, storage):
        self.cfg = cfg
        self.storage = storage
        caps = storage.capabilities()
        self.enabled = caps.tunable
        # routing/migration additionally need the migratable capability
        # (device AND a closed backend both stay inert)
        self.migratable = caps.migratable
        self.batches = 0
        self.events: list[dict] = []
        # while True, the queue-depth leg holds: an engaged SLO controller
        # (serving/slo.py) owns the depth during a breach, and two
        # controllers steering one knob is the oscillation the tests pin
        # down. The other legs (capacity/routing/migration) keep running.
        self.depth_suspended = False
        self._last = self._snapshot() if self.enabled else {}
        self._last_depth = storage.prefetch_depth() if self.enabled else 0

    def _snapshot(self) -> dict:
        s = self.storage.stats()
        return {k: s.get(k, 0)
                for k in ("consume_ready", "consume_waited")}

    def step(self) -> None:
        if not self.enabled:
            return                      # device et al.: inert by design
        self.batches += 1
        self._last_depth = self.storage.prefetch_depth()
        c = self.cfg
        if c.depth_every_batches and \
                self.batches % c.depth_every_batches == 0:
            if self.depth_suspended:
                # don't tune, but DO roll the observation window forward:
                # resuming against counters from before the suspension
                # would hand the controller a stale overlap fraction
                self._last = self._snapshot()
                self.storage.take_prefetch_window_peak()
            else:
                self._depth_step()
        if c.capacity_every_batches and \
                self.batches % c.capacity_every_batches == 0:
            self._capacity_step()
        if self.migratable and c.route_every_batches and \
                self.batches % c.route_every_batches == 0:
            self._route_step()
        if self.migratable and c.migrate_every_batches and \
                self.batches % c.migrate_every_batches == 0:
            self._migrate_step()

    def _depth_step(self) -> None:
        now = self._snapshot()
        ready = now["consume_ready"] - self._last["consume_ready"]
        waited = now["consume_waited"] - self._last["consume_waited"]
        self._last = now
        window_peak = self.storage.take_prefetch_window_peak()
        depth = self.storage.prefetch_depth()
        if depth == 0:
            return      # staging deliberately off: never re-enable it
        consumed = ready + waited
        # <= 0 also covers a stats reset mid-window (negative deltas):
        # treat it as an idle window rather than inventing an overlap
        overlap = ready / consumed if consumed > 0 else None
        want = self.cfg.controller.propose(depth, overlap, window_peak)
        if want != depth and self.storage.set_prefetch_depth(want):
            self.events.append({"kind": "depth", "batch": self.batches,
                                "from": depth, "to": want,
                                "overlap_frac": overlap})

    def _capacity_step(self) -> None:
        from repro_torch.core.plan import estimate_device_budget
        budget = estimate_device_budget(
            fraction=self.cfg.budget_fraction,
            fallback_bytes=self.cfg.budget_fallback_bytes)
        if budget is None:
            return
        result = self.storage.retune_capacities(budget)
        if result is not None:
            self.events.append({"kind": "capacity", "batch": self.batches,
                                **result})

    def _route_step(self) -> None:
        """Fold the window's per-replica service costs into the backend's
        replica routers (serving thread — a routing move flushes staged
        batches, which must not race an in-flight fan-out)."""
        result = self.storage.update_routing()
        if result is not None and result.get("changed"):
            self.events.append({"kind": "routing", "batch": self.batches,
                                "fractions": result["fractions"]})

    def _migrate_step(self) -> None:
        """Re-plan placement from the live window; install only past the
        threshold. A None plan (balanced enough / empty window) is the
        normal case and logs nothing."""
        plan = self.storage.plan_migration(
            threshold=self.cfg.migrate_threshold)
        if plan is None:
            return
        result = self.storage.install_migration(plan)
        if result.get("migrated"):
            self.events.append({"kind": "migration",
                                "batch": self.batches, **result})

    def summary(self) -> dict:
        """Merged into `ServingSession.percentiles()` when tuning ran."""
        if not self.enabled:
            return {}
        # a backend closed since the last step legitimately reports depth
        # 0; the summary wants the depth the loop actually served at
        depth = (self.storage.prefetch_depth()
                 if self.storage.capabilities().tunable
                 else self._last_depth)
        out = {"prefetch_depth": depth,
               "depth_retunes": sum(e["kind"] == "depth"
                                    for e in self.events)}
        cap = [e for e in self.events if e["kind"] == "capacity"]
        if self.cfg.capacity_every_batches:
            out["capacity_retunes"] = len(cap)
        if self.migratable and self.cfg.migrate_every_batches:
            out["migrations"] = sum(e["kind"] == "migration"
                                    for e in self.events)
        if self.migratable and self.cfg.route_every_batches:
            out["routing_updates"] = sum(e["kind"] == "routing"
                                         for e in self.events)
        return out

@dataclasses.dataclass(frozen=True)
class ArbiterConfig:
    """How the multi-tenant `BudgetArbiter` re-splits shared resources.

    `every_batches` counts EXECUTED batches across all tenants (the
    manager steps the arbiter once per executed batch, whichever tenant
    it belonged to), so a busy tenant naturally triggers re-arbitration
    sooner. 0 disables the arbiter entirely.
    """

    # re-arbitrate every N executed batches across all tenants (0 = off)
    every_batches: int = 16
    # fraction of the estimated free device bytes split across tenants
    budget_fraction: float = 0.5
    # static fallback when the runtime exposes no memory stats; None
    # skips arbitration in that case (CPU backends should set this)
    budget_fallback_bytes: Optional[int] = None
    # demand-share floor: even a fully idle tenant keeps this fraction of
    # the budget, so a flash-crowd neighbor can squeeze but never starve
    # it (shares are re-normalized to sum to 1 after flooring)
    min_share: float = 0.1
    # also re-split prefetch depth by the same shares (SLO-engaged
    # tenants are skipped: their breach handler owns the depth knob)
    retune_depth: bool = True
    depth_min: int = 1
    depth_max: int = 8

    def __post_init__(self):
        if not (0.0 <= self.min_share <= 1.0):
            raise ValueError("need 0 <= min_share <= 1")
        if not (1 <= self.depth_min <= self.depth_max):
            raise ValueError("need 1 <= depth_min <= depth_max")


class BudgetArbiter:
    """Fair-share controller over N tenant views of one shared backend.

    Holds one access-counter snapshot per tenant; `step()` (called by the
    manager after every executed batch, any tenant) re-arbitrates at each
    interval boundary:

      demand_t = max(0, total_accesses_t - last_t)        (the live load)
      share_t  = normalize(max(demand_t / sum, min_share))
      budget_t = share_t * estimate_device_budget(...)    -> retune
      depth_t  = clamp(share_t * pool, depth_min, depth_max)

    where the depth pool is `num_tenants * (depth_min + depth_max) / 2`:
    equal shares land every tenant at the midpoint, a flash-crowd tenant
    climbs toward `depth_max` while the squeezed neighbor floors at
    `depth_min` — never below, so containment (the bench invariant) holds
    by construction. Because the shares sum to exactly 1 and each budget
    is floored to an int, Σ budget_t <= the one shared budget: the
    conservation law `tests/test_tenants.py` pins down.
    """

    def __init__(self, cfg: ArbiterConfig, views: dict):
        if not views:
            raise ValueError("BudgetArbiter needs at least one tenant view")
        self.cfg = cfg
        self.views = dict(views)
        self.enabled = bool(cfg.every_batches) and all(
            v.capabilities().tunable for v in self.views.values())
        self.batches = 0
        self.events: list[dict] = []
        self.last_shares: dict[str, float] = {}
        self._last = {n: self._accesses(v)
                      for n, v in self.views.items()} if self.enabled else {}

    @staticmethod
    def _accesses(view) -> int:
        return int(view.stats().get("total_accesses", 0))

    def step(self, engaged=frozenset()) -> None:
        """One executed batch somewhere; `engaged` names tenants whose
        SLO controller currently owns their depth knob."""
        if not self.enabled:
            return
        self.batches += 1
        if self.batches % self.cfg.every_batches:
            return
        self._arbitrate(frozenset(engaged))

    def _arbitrate(self, engaged: frozenset) -> None:
        from repro_torch.core.plan import estimate_device_budget
        budget = estimate_device_budget(
            fraction=self.cfg.budget_fraction,
            fallback_bytes=self.cfg.budget_fallback_bytes)
        if budget is None:
            return
        now = {n: self._accesses(v) for n, v in self.views.items()}
        demand = {n: max(0, now[n] - self._last.get(n, 0)) for n in now}
        self._last = now
        total = sum(demand.values())
        if total <= 0:      # idle interval: everyone is "equally loaded"
            raw = {n: 1.0 / len(self.views) for n in self.views}
        else:
            raw = {n: demand[n] / total for n in demand}
        floored = {n: max(s, self.cfg.min_share) for n, s in raw.items()}
        norm = sum(floored.values())
        shares = {n: s / norm for n, s in floored.items()}
        self.last_shares = shares
        depth_pool = len(self.views) * (self.cfg.depth_min
                                        + self.cfg.depth_max) / 2.0
        budgets, depths = {}, {}
        for name, view in self.views.items():
            budgets[name] = int(budget * shares[name])
            view.retune_capacities(budgets[name])
            if self.cfg.retune_depth and name not in engaged:
                want = max(self.cfg.depth_min,
                           min(self.cfg.depth_max,
                               round(shares[name] * depth_pool)))
                if view.prefetch_depth() != want and \
                        view.set_prefetch_depth(want):
                    depths[name] = want
        self.events.append({"kind": "arbiter", "batch": self.batches,
                            "budget_bytes": int(budget), "shares": shares,
                            "budgets": budgets, "depths": depths,
                            "skipped_engaged": sorted(engaged)})

    def summary(self) -> dict:
        """Merged into the manager's `percentiles()` shared section."""
        if not self.enabled:
            return {}
        return {"arbiter_rounds": len(self.events),
                "arbiter_shares": dict(self.last_shares)}
