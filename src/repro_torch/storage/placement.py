"""Frequency-aware table-to-shard placement (the cost-model-driven planner).

`ShardedStorage` used to split the table stack into contiguous groups —
fine when every table carries the same traffic, badly imbalanced under the
skew the paper is all about (§III-B: unique-access rates span 0.0002% to
63% across hotness classes; Gupta et al. observe the same spread across
production tables). A shard's serving cost is dominated by the rows it must
actually move per batch, so the planner models each table's load as

    load(t) = unique-access rate(t) x row bytes

(`estimate_table_loads`, reusing the coverage machinery of `core.plan`:
per-batch distinct-row counts from the same [N, T, L] offline trace every
other planner entry consumes) and assigns tables to shards with greedy
longest-processing-time (LPT) balancing — sort by descending load, place
each table on the currently lightest shard. LPT is the classic 4/3-optimal
makespan heuristic; for the handful-of-tables-per-shard shapes here it is
within a few percent of optimal and fully deterministic.

Replication escape hatch: when one table's load alone exceeds the mean
shard load (`replicate_factor`), no assignment can balance it — the paper's
`one_item`-style tables in reverse. The planner may then split that table
into R replicas (each `load/R`), placed on DISTINCT shards; at serve time
`ShardedStorage` routes an equal slice of the batch to each replica. Every
replica holds byte-identical rows, so placement — like every other
placement — never changes served values.

The result is a `ShardPlacement`: a pure, picklable description consumed by
`ShardedStorage.build(placement=...)` and exposed through the planner API
as `repro_torch.core.plan.plan_shard_placement`.

Two serving-time companions make the placement *live* instead of
build-time-frozen (the HugeCTR inference PS re-balances its GPU cache
online for the same reason; production skew drifts on the timescale of
minutes):

  `plan_migration`   — re-run the planner on a LIVE traffic window and,
                       when the current placement's imbalance under the
                       fresh loads exceeds a threshold AND the re-planned
                       placement wins by a material margin, emit a
                       `MigrationPlan` (which tables move or change
                       replica count). `ShardedStorage.install_migration`
                       applies it build-before-teardown.
  `ReplicaRouter`    — per-replicated-table batch splitter: instead of
                       equal slices, each replica's share of the batch is
                       proportional to the inverse of its observed service
                       cost (EWMA of per-unit lookup seconds per row), so
                       a slow or contended replica sheds load. A `min_frac`
                       floor keeps a trickle of traffic on every replica so
                       costs stay observable and a recovered replica can
                       win its share back.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: imbalance ratio (max shard load / mean shard load) above which
#: `plan_migration` considers the live placement worth re-planning
DEFAULT_MIGRATION_THRESHOLD = 1.25


def estimate_table_loads(trace: np.ndarray, row_bytes: int = 1
                         ) -> np.ndarray:
    """Per-table load estimate from an offline trace: mean distinct rows
    per batch x `row_bytes`.

    trace: [N, T, L] raw row ids (or [N, L] for one table). The distinct
    count is per batch — the unit of gather traffic a shard actually
    serves (duplicates within a batch coalesce into one row fetch, the
    same coalescing `ParameterServer._lookup_table` performs).
    Returns float64 [T].
    """
    trace = np.asarray(trace)
    if trace.ndim == 2:
        trace = trace[:, None, :]
    assert trace.ndim == 3, "expected trace [N, T, L]"
    N, T, _ = trace.shape
    loads = np.empty(T, np.float64)
    for t in range(T):
        loads[t] = sum(len(np.unique(trace[n, t])) for n in range(N)) / N
    return loads * float(row_bytes)


@dataclasses.dataclass(frozen=True)
class ShardPlacement:
    """Table-to-shard assignment with per-table load estimates.

    `replicas[t]` lists the shards holding a copy of table `t` (length 1
    for a normal placement; >1 only through the replication escape hatch).
    A replicated table contributes `loads[t] / len(replicas[t])` to each
    owning shard — the serving layer splits the batch evenly across
    replicas, so the load really does divide.
    """

    num_tables: int
    num_shards: int
    replicas: tuple[tuple[int, ...], ...]   # table -> owning shard ids
    loads: tuple[float, ...]                # table -> estimated load
    strategy: str = "balanced"              # 'contiguous' | 'balanced' | ...

    def __post_init__(self):
        if len(self.replicas) != self.num_tables or \
                len(self.loads) != self.num_tables:
            raise ValueError("replicas/loads must have one entry per table")
        for t, owners in enumerate(self.replicas):
            if not owners:
                raise ValueError(f"table {t} is assigned to no shard")
            if len(set(owners)) != len(owners):
                raise ValueError(f"table {t} replicated twice on one shard")
            if not all(0 <= s < self.num_shards for s in owners):
                raise ValueError(f"table {t} assigned to unknown shard")

    # -- derived views -------------------------------------------------------
    @property
    def shard_tables(self) -> tuple[tuple[int, ...], ...]:
        """Per-shard ascending table ids (replicated tables appear on each
        owner) — the order `ShardedStorage` stacks each shard's tables in."""
        out: list[list[int]] = [[] for _ in range(self.num_shards)]
        for t, owners in enumerate(self.replicas):
            for s in owners:
                out[s].append(t)
        return tuple(tuple(ts) for ts in out)

    @property
    def shard_loads(self) -> np.ndarray:
        """Estimated load per shard (replicas split their table's load)."""
        loads = np.zeros(self.num_shards, np.float64)
        for t, owners in enumerate(self.replicas):
            for s in owners:
                loads[s] += self.loads[t] / len(owners)
        return loads

    def imbalance_ratio(self) -> float:
        """max shard load / mean shard load (1.0 = perfectly balanced)."""
        loads = self.shard_loads
        mean = loads.mean()
        return float(loads.max() / mean) if mean > 0 else 1.0

    @property
    def replicated_tables(self) -> tuple[int, ...]:
        return tuple(t for t, o in enumerate(self.replicas) if len(o) > 1)

    def with_loads(self, loads: np.ndarray) -> "ShardPlacement":
        """The SAME assignment re-costed under fresh load estimates — how
        `plan_migration` asks "what does the live traffic think of the
        placement we are serving?"."""
        loads = np.asarray(loads, np.float64)
        if len(loads) != self.num_tables:
            raise ValueError(f"{len(loads)} loads for {self.num_tables} "
                             f"tables")
        return dataclasses.replace(
            self, loads=tuple(float(x) for x in loads))

    def describe(self) -> str:
        """Human-readable shard load table (the example's --placement
        printout)."""
        loads = self.shard_loads
        lines = [f"placement={self.strategy} shards={self.num_shards} "
                 f"imbalance={self.imbalance_ratio():.3f}"]
        for s, tabs in enumerate(self.shard_tables):
            marks = [f"{t}{'*' if len(self.replicas[t]) > 1 else ''}"
                     for t in tabs]
            lines.append(f"  shard {s}: load={loads[s]:10.1f}  "
                         f"tables=[{', '.join(marks)}]")
        if self.replicated_tables:
            lines.append(f"  (* = replicated: "
                         f"{list(self.replicated_tables)})")
        return "\n".join(lines)

    # -- constructors --------------------------------------------------------
    @classmethod
    def contiguous(cls, num_tables: int, num_shards: int,
                   loads: np.ndarray | None = None) -> "ShardPlacement":
        """The legacy split: `num_shards` contiguous groups. `loads` (when
        known) ride along so the imbalance of the old scheme is reportable."""
        num_shards = max(1, min(num_shards, num_tables))
        bounds = np.linspace(0, num_tables, num_shards + 1).astype(int)
        replicas = []
        for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            replicas += [(s,)] * (hi - lo)
        if loads is None:
            loads = np.ones(num_tables, np.float64)
        return cls(num_tables=num_tables, num_shards=num_shards,
                   replicas=tuple(replicas),
                   loads=tuple(float(x) for x in np.asarray(loads)),
                   strategy="contiguous")


def plan_shard_placement(trace: np.ndarray, num_shards: int, *,
                         row_bytes: int = 1,
                         loads: np.ndarray | None = None,
                         replicate_factor: float = 0.0,
                         max_replicas: int | None = None) -> ShardPlacement:
    """Greedy LPT table-to-shard balancing from a traffic trace.

    trace: [N, T, L] raw row ids (ignored when explicit `loads` are given).
    row_bytes: per-row gather cost (dim x itemsize); a common scale factor
        cancels in the balance, so the default 1 only matters for absolute
        load readouts.
    replicate_factor: 0 disables replication. Otherwise a table whose load
        exceeds `replicate_factor x (total load / num_shards)` is split
        into enough replicas to bring each below that bound (capped at
        `max_replicas`, default `num_shards`).

    Deterministic: ties in the LPT sort break by table id, ties in the
    least-loaded-shard choice break by shard id.
    """
    if loads is None:
        loads = estimate_table_loads(trace, row_bytes)
    loads = np.asarray(loads, np.float64)
    T = len(loads)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    num_shards = min(num_shards, T)
    max_replicas = num_shards if max_replicas is None else \
        max(1, min(max_replicas, num_shards))

    # replication escape hatch: split dominant tables into r copies
    n_rep = np.ones(T, np.int64)
    if replicate_factor > 0 and num_shards > 1:
        fair = loads.sum() / num_shards
        if fair > 0:
            over = loads > replicate_factor * fair
            n_rep[over] = np.minimum(
                np.ceil(loads[over] / (replicate_factor * fair)
                        ).astype(np.int64),
                max_replicas)

    # LPT over (table, replica) items with per-replica load
    items = [(t, loads[t] / n_rep[t]) for t in range(T)
             for _ in range(n_rep[t])]
    items.sort(key=lambda it: (-it[1], it[0]))
    shard_load = np.zeros(num_shards, np.float64)
    owners: list[list[int]] = [[] for _ in range(T)]
    for t, load in items:
        # lightest shard not already holding a replica of t
        order = np.lexsort((np.arange(num_shards), shard_load))
        s = next(int(s) for s in order if int(s) not in owners[t])
        owners[t].append(s)
        shard_load[s] += load
    return ShardPlacement(
        num_tables=T, num_shards=num_shards,
        replicas=tuple(tuple(sorted(o)) for o in owners),
        loads=tuple(float(x) for x in loads), strategy="balanced")


# ---------------------------------------------------------------------------
# live migration planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """A placement change worth paying for: which tables move (or change
    replica count), and the imbalance the move buys back.

    Pure description — `ShardedStorage.install_migration` does the actual
    build-before-teardown swap. `old` carries the LIVE loads (the serving
    placement re-costed under the planning window), so
    `imbalance_before == old.imbalance_ratio()`.
    """

    old: ShardPlacement
    new: ShardPlacement
    moved_tables: tuple[int, ...]        # owner set changed at all
    imbalance_before: float              # old placement, live loads
    imbalance_after: float               # new placement, live loads

    @property
    def replica_changes(self) -> tuple[int, ...]:
        """Tables whose replica COUNT changed (subset of moved_tables)."""
        return tuple(t for t in self.moved_tables
                     if len(self.old.replicas[t]) != len(self.new.replicas[t]))

    def describe(self) -> str:
        return (f"migrate {len(self.moved_tables)} table(s) "
                f"{list(self.moved_tables)}: imbalance "
                f"{self.imbalance_before:.3f} -> {self.imbalance_after:.3f}"
                + (f" (replica count changes: {list(self.replica_changes)})"
                   if self.replica_changes else ""))


def plan_migration(old: ShardPlacement, trace: np.ndarray | None = None, *,
                   loads: np.ndarray | None = None,
                   row_bytes: int = 1,
                   threshold: float = DEFAULT_MIGRATION_THRESHOLD,
                   min_gain: float = 0.05,
                   replicate_factor: float = 0.0,
                   max_replicas: int | None = None
                   ) -> MigrationPlan | None:
    """Decide whether the serving placement should follow traffic drift.

    Re-costs `old` under load estimates from the LIVE `trace` (or explicit
    `loads`) and re-runs the LPT planner at the same shard count. Returns
    None — migration is the exception, not the rule — unless ALL hold:

      * the live imbalance of `old` exceeds `threshold`;
      * the re-planned placement improves imbalance by at least `min_gain`
        (absolute), so sub-noise wins never churn the caches;
      * at least one table actually moves.

    Single-shard placements never migrate (nothing to balance).
    """
    if old.num_shards <= 1:
        return None
    if loads is None:
        if trace is None:
            raise ValueError("plan_migration needs a live trace= (or "
                             "explicit loads=) to re-cost the placement")
        loads = estimate_table_loads(trace, row_bytes)
    loads = np.asarray(loads, np.float64)
    cur = old.with_loads(loads)
    before = cur.imbalance_ratio()
    if before <= threshold:
        return None
    new = plan_shard_placement(trace, old.num_shards, row_bytes=row_bytes,
                               loads=loads,
                               replicate_factor=replicate_factor,
                               max_replicas=max_replicas)
    after = new.imbalance_ratio()
    if before - after < min_gain:
        return None
    moved = tuple(t for t in range(old.num_tables)
                  if set(old.replicas[t]) != set(new.replicas[t]))
    if not moved:
        return None
    return MigrationPlan(old=cur, new=new, moved_tables=moved,
                         imbalance_before=before, imbalance_after=after)


# ---------------------------------------------------------------------------
# load-aware replica routing
# ---------------------------------------------------------------------------

class ReplicaRouter:
    """Cost-proportional batch splitter for ONE replicated table.

    Tracks an EWMA of each replica's observed service cost (seconds per
    routed batch row — lookup latency including any prefetch-consume wait)
    and cuts each batch so replica k's slice is proportional to
    `1 / cost_k`. Until the first observation the split is equal
    (`np.array_split` law), which is also the exact legacy behaviour.

    `min_frac` keeps every replica above a small floor so (a) a slow
    replica keeps producing cost observations and can win its share back
    when it recovers, and (b) no replica's slice collapses to a
    permanently-unobservable zero.

    Deterministic and pure: `bounds()` is a function of the stored EWMA
    state only; the serving layer decides when `observe()` runs (router
    moves invalidate staged batches, so updates happen at window
    boundaries, never mid-batch).
    """

    def __init__(self, num_replicas: int, *, alpha: float = 0.5,
                 min_frac: float = 0.05):
        if num_replicas < 2:
            raise ValueError("routing needs >= 2 replicas")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("need 0 < alpha <= 1")
        if min_frac < 0.0:
            raise ValueError("need min_frac >= 0")
        self.num_replicas = num_replicas
        self.alpha = float(alpha)
        # clamp to half the equal share so the floor stays meaningful at
        # ANY replica count — constructing a router must never raise for
        # a valid placement (it runs mid-swap in _install_units)
        self.min_frac = min(float(min_frac), 0.5 / num_replicas)
        self.costs = np.ones(num_replicas, np.float64)   # relative s/row
        self.observed = False
        # the PUBLISHED split `bounds()` cuts by. The EWMA may drift every
        # observe(); the published fractions move only when the drift
        # exceeds the tolerance — so bounds change exactly when observe()
        # returns True, and the caller's staged-batch flush is exact (a
        # silently shifted bound would strand unmatchable staged batches
        # in the bounded queues forever).
        self._active: np.ndarray | None = None

    def _equal(self) -> np.ndarray:
        return np.full(self.num_replicas, 1.0 / self.num_replicas)

    def fractions(self) -> np.ndarray:
        """The published per-replica batch share (sums to 1; equal until
        the first above-tolerance observation)."""
        return self._equal() if self._active is None else self._active

    def _raw_fractions(self) -> np.ndarray:
        """Inverse-cost shares straight off the EWMA, floored at
        min_frac — what `observe()` publishes when it moved enough."""
        if not self.observed:
            return self._equal()
        w = 1.0 / np.maximum(self.costs, 1e-12)
        f = w / w.sum()
        if self.min_frac > 0.0:
            f = np.maximum(f, self.min_frac)
            f = f / f.sum()
        return f

    def bounds(self, batch: int) -> np.ndarray:
        """Cut points [num_replicas + 1] partitioning `[0, batch)`;
        replica k serves rows `[bounds[k], bounds[k+1])`. A pure function
        of the published fractions.

        Whenever `batch >= num_replicas`, EVERY replica gets at least one
        row: one row per replica is reserved off the top and only the
        remainder splits proportionally. Rounding a tiny published
        fraction straight to a zero-width slice would freeze that
        replica's cost observations (no rows -> NaN cost -> EWMA never
        updates) and starve it permanently — the exact failure min_frac
        exists to prevent. Batches smaller than the replica count
        necessarily leave some replicas empty and fall back to the equal
        law."""
        r = self.num_replicas
        if self._active is None or batch < r:
            base, extra = divmod(batch, r)
            sizes = base + (np.arange(r) < extra)
            return np.concatenate(([0], np.cumsum(sizes))).astype(np.int64)
        cum = np.concatenate(([0.0], np.cumsum(self._active)))
        cum[-1] = 1.0                         # kill float-sum residue
        # round(monotone) + strictly-increasing arange => strictly
        # increasing bounds: width >= 1 everywhere by construction
        return (np.round(cum * (batch - r)).astype(np.int64)
                + np.arange(r + 1))

    def observe(self, costs: np.ndarray, *, tol: float = 0.02) -> bool:
        """Fold one window's per-replica cost samples (s/row; NaN = the
        replica served nothing this window, its EWMA is left alone) into
        the EWMA, and re-publish the split when it moved by more than
        `tol` anywhere. Returns True exactly when the published split —
        and therefore `bounds()` — changed, the caller's signal that
        staged batches cut at the old bounds are now stale."""
        costs = np.asarray(costs, np.float64)
        if costs.shape != (self.num_replicas,):
            raise ValueError(f"expected {self.num_replicas} costs, got "
                             f"{costs.shape}")
        seen = np.isfinite(costs) & (costs > 0)
        if not seen.any():
            return False
        if not self.observed:
            # first window: seed unseen replicas at the seen mean so one
            # early observation cannot starve the others
            self.costs[:] = costs[seen].mean()
        self.costs[seen] += self.alpha * (costs[seen] - self.costs[seen])
        self.observed = True
        raw = self._raw_fractions()
        if np.abs(raw - self.fractions()).max() > tol:
            self._active = raw
            return True
        return False
