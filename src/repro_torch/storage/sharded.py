"""`sharded` backend — table-wise partitioning of the tiered store.

The next scaling axis after the single tiered parameter server
(Gupta et al.: table-wise sharding is how production DLRM fleets spread
embedding capacity; the ROADMAP's "multi-host sharded cold tier" item).
Each shard owns a full `repro_torch.ps.ParameterServer` over its tables —
its own hot block, its own warm caches, its own prefetch queue (and, with
`async_prefetch=True`, its own gather worker thread).

Which tables a shard owns comes from a `ShardPlacement`
(`repro_torch.storage.placement`): the legacy contiguous split, or the
frequency-aware planner (`plan_shard_placement`) that LPT-balances
per-table load estimates — and may replicate a dominant table across
several shards, in which case each replica serves a slice of the batch.
Internally every (shard, table-group) pair is a *unit* holding one
ParameterServer: a shard has one unit for its non-replicated tables plus
one per replica it hosts, executed serially on that shard's worker.

The placement is LIVE, not build-time-frozen:

  * **Routing** — a replicated table's batch slices start equal
    (`np.array_split` law) and, once `update_routing()` has folded a
    window of per-unit service costs into each table's `ReplicaRouter`,
    become proportional to inverse observed cost, so a slow or contended
    replica sheds load. A routing move flushes staged prefetch batches
    (they were cut at the old bounds); correctness never depends on them.
  * **Migration** — `plan_migration()` re-runs the placement planner on
    the backend's own sliding traffic window and, past an imbalance
    threshold, emits a plan; `install_migration()` applies it
    build-before-teardown: the new units (and their ParameterServers) are
    fully constructed first, swapped in atomically, and only then are the
    orphaned old units closed — a failed or rejected migration always
    leaves the old backend serving. `plan_refresh`/`install_refresh`
    carry the same plan when a `migration_threshold` was configured at
    build time, so periodic re-pinning doubles as periodic re-placement.

Single-process multi-shard for now: `lookup()`/`stage()` fan out over a
shard thread pool and join before returning, so each unit's PS still sees
the strictly serialized call pattern its threading model requires (one
outstanding call per PS; units touch disjoint (table, batch-slice)
regions). The protocol surface is shard-count-agnostic — a later
multi-host version replaces the pool with RPC stubs without changing any
caller. On the card the shard threads launch the fused kernel (once per
unit a forward) and the embedding-bag kernel (each unit's bag completion)
on each thread's current stream, the legacy default stream, so launches
from different shards serialize on the device.

Bit-exactness: every unit serves byte-identical copies of its table slice.
On the fused path each unit's pooled [b, t, D] block is copied on the
device into rows lo:hi and columns `cols` of one [B, T, D] output — each
bag is pooled exactly as a single tiered server (and so the `device`
backend) pools it. On the per-row path the per-unit row blocks rebuild the
[B, T, L, D] buffer a single tiered server would have gathered, pooled
once on the device. Either way the output is bit-identical — for ANY
placement, replicated or not, routed or not, before/during/after a
migration swap.

Stats: per-shard counters merge into ONE report — counter keys sum, rates
are recomputed from the summed true counters, instantaneous gauges
(`queue_depth`) and per-shard peaks (`max_queue_depth`) take the per-shard
max, and the unmerged snapshots ride along under `"per_shard"`.

Multi-tenant mode (`build(..., tenants={name: table_count})`): the table
axis tiles into contiguous per-tenant namespaces and every unit becomes
TENANT-PURE — each shard gets one solo unit per tenant instead of one
overall (a `ParameterServer` serves full batches over its whole table
group, so a unit that mixed tenants could never serve one tenant's
lookup). The whole-backend `lookup()`/`stage()` become undefined (they
raise); tenants serve through `tenant_lookup()` & friends — normally via
the `repro_torch.storage.tenancy.TenantStorage` facade — with tenant-local
[B, T_tenant, L] indices mapped onto each unit's `cols`. Hot/warm
capacity stays ONE shared device budget, re-split per tenant by
`tenant_retune_capacities` (driven by `repro_torch.ps.tuning.BudgetArbiter`);
`stats()` reports `{"tenants": {...}, "shared": {...}}`; migration is
disabled (the arbiter, not placement moves, is the live fairness
mechanism under tenancy). `attach_tenant`/`detach_tenant` add/remove a
tenant mid-serving without touching any sibling unit — sibling
bit-exactness is structural, not incidental.

A port of `repro/storage/sharded.py`. Where it differs: `build()` takes no
params (the collection's host `tables` are the authoritative copy each
unit's tables are copied from, as the tiered backend reads them), every
unit's ParameterServer and the pooled output live on the collection's
device, and nothing of the fused fan-out round-trips through the host.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from collections import deque
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.embedding_bag import fused
from repro_torch.storage.base import EmbeddingStorage, StorageCapabilities
from repro_torch.storage.placement import (DEFAULT_MIGRATION_THRESHOLD,
                                           MigrationPlan, ReplicaRouter,
                                           ShardPlacement,
                                           estimate_table_loads,
                                           plan_migration,
                                           plan_shard_placement)
from repro_torch.storage.registry import register
from repro_torch.storage.tenancy import TenantNamespace, resolve_tenants
from repro_torch.storage.tiered import (_as_numpy, _reject_double_remap,
                                        build_ps_config)

# merged by summation; rates are recomputed from the summed numerators
_SUM_KEYS = ("total_accesses", "hot_hits", "warm_hits", "cold_misses",
             "evictions", "insertions", "warm_occupancy",
             "cold_gathered_rows", "staged_rows", "prefetch_hits",
             "prefetch_misses", "off_critical_rows",
             "consume_ready", "consume_waited", "consume_wait_s",
             "degraded_rows", "degraded_l2_sq")
# merged by maximum: per-shard peaks, lockstep counters, and instantaneous
# gauges (summing `queue_depth` across shards would report a depth no
# single queue ever had — the auto-tuner and operators read this).
# `degraded_lookups` is lockstep too: every unit serves (its slice of)
# every degraded batch, so the max is the batch count a single tiered
# server would have reported.
_MAX_KEYS = ("max_queue_depth", "refreshes", "queue_depth",
             "degraded_lookups")


def merge_shard_stats(per_shard: list[dict]) -> dict:
    """Fold per-shard counter snapshots into one report.

    Invariant preserved: summed `hot_hits + warm_hits + cold_misses ==
    total_accesses` (it holds per shard, and all three are sums). Rates
    are recomputed from the summed TRUE counters only — gauges like
    `queue_depth` merge by max and never feed a rate.
    """
    out: dict = {"num_shards": len(per_shard)}
    for k in _SUM_KEYS:
        if any(k in s for s in per_shard):
            out[k] = sum(s.get(k, 0) for s in per_shard)
    for k in _MAX_KEYS:
        if any(k in s for s in per_shard):
            out[k] = max(s.get(k, 0) for s in per_shard)
    total = out.get("total_accesses", 0)
    out["hot_hit_rate"] = out.get("hot_hits", 0) / total if total else 0.0
    out["warm_hit_rate"] = out.get("warm_hits", 0) / total if total else 0.0
    out["cold_miss_rate"] = (out.get("cold_misses", 0) / total
                             if total else 0.0)
    out["cache_hit_rate"] = ((out.get("hot_hits", 0)
                              + out.get("warm_hits", 0)) / total
                             if total else 0.0)
    resolved = out.get("prefetch_hits", 0) + out.get("prefetch_misses", 0)
    out["off_critical_frac"] = (out.get("off_critical_rows", 0) / resolved
                                if resolved else 0.0)
    consumed = out.get("consume_ready", 0) + out.get("consume_waited", 0)
    if consumed or any("consume_ready" in s for s in per_shard):
        out["consume_overlap_frac"] = (out.get("consume_ready", 0) / consumed
                                       if consumed else 0.0)
    if "degraded_l2_sq" in out:
        # per-shard deltas are sqrt's — they don't sum; re-derive from the
        # summed squared error so the merged delta is the exact L2 error
        # of the whole zero-filled [B, T, L, D] tensor
        out["degraded_l2_delta"] = float(np.sqrt(out["degraded_l2_sq"]))
    out["per_shard"] = per_shard
    return out


def _chunk_bounds(batch: int, num_chunks: int, k: int) -> tuple[int, int]:
    """Equal batch split for replica k of num_chunks (np.array_split law:
    the first `batch % num_chunks` chunks get the extra row, so B=5, n=2
    splits (3, 2))."""
    base, extra = divmod(batch, num_chunks)
    lo = k * base + min(k, extra)
    return lo, lo + base + (1 if k < extra else 0)


def resolve_placement(cfg, placement, num_shards: int,
                      trace: Optional[np.ndarray]) -> ShardPlacement:
    """Turn a `placement=` build argument ('contiguous' / 'balanced' / an
    explicit `ShardPlacement` / None) into a validated `ShardPlacement`
    for `cfg`'s table geometry — shared by the sharded and pool backends."""
    row_bytes = cfg.dim * cfg.torch_dtype.itemsize
    if placement is None or placement == "contiguous":
        loads = (None if trace is None
                 else estimate_table_loads(trace, row_bytes))
        return ShardPlacement.contiguous(cfg.num_tables, num_shards,
                                         loads=loads)
    if placement == "balanced":
        if trace is None:
            raise ValueError("placement='balanced' needs a trace= to "
                             "estimate per-table loads from (or pass a "
                             "pre-planned ShardPlacement)")
        return plan_shard_placement(trace, num_shards, row_bytes=row_bytes)
    if isinstance(placement, ShardPlacement):
        if placement.num_tables != cfg.num_tables:
            raise ValueError(
                f"placement plans {placement.num_tables} tables but the "
                f"collection has {cfg.num_tables}")
        return placement
    raise ValueError(f"placement must be 'contiguous', 'balanced', or a "
                     f"ShardPlacement, got {placement!r}")


@dataclasses.dataclass
class _Unit:
    """One ParameterServer worth of placement: a shard's non-replicated
    table group (`chunk is None`, full batch) or a single replicated
    table's copy (`chunk=(k, r)`: batch slice k of r). Replica units
    accumulate service-cost observations (`service_s` over `served_rows`)
    for the table's `ReplicaRouter`; only their owning shard worker
    writes them.

    Under tenancy a unit is tenant-pure: `tenant` names its owner and
    `cols` maps `table_ids` to the columns of the CALLER's [B, T, L]
    batch — tenant-local columns for a tenant unit, the global ids
    otherwise."""
    shard: int
    table_ids: np.ndarray                 # global table ids, ascending
    ps: object                            # repro_torch.ps.ParameterServer
    chunk: Optional[tuple[int, int]] = None
    service_s: float = 0.0                # replica units: window lookup time
    served_rows: int = 0                  # replica units: window batch rows
    tenant: Optional[str] = None
    cols: Optional[np.ndarray] = None     # caller-batch columns

    def __post_init__(self):
        if self.cols is None:
            self.cols = self.table_ids


@register("sharded")
class ShardedStorage(EmbeddingStorage):
    """Table-sharded tiered storage: N parameter servers, one report."""

    def __init__(self, ebc):
        super().__init__(ebc)
        _reject_double_remap(self.cfg, "sharded")
        self.shards: list = []            # flat list: every unit's PS
        self.placement: Optional[ShardPlacement] = None
        self.table_slices: list[slice] = []   # contiguous placements only
        self.migration_threshold: Optional[float] = None
        self._units: list[_Unit] = []
        self._shard_units: list[list[_Unit]] = []
        self._routers: dict[int, ReplicaRouter] = {}
        self._valid_hint: Optional[int] = None
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._closed = False
        self._epoch = 0                   # bumped by build() and migration
        self._tables: Optional[np.ndarray] = None    # authoritative copy
        self._ps_cfg = None
        self._replicate_factor = 0.0
        self._degraded = False        # backend-level: survives migration
        self._tenants: dict[str, TenantNamespace] = {}
        self._tenant_hints: dict[str, int] = {}
        self._tenant_degraded: dict[str, bool] = {}
        # online model updates: whole-backend version/transaction plus
        # per-tenant counterparts (tenants upgrade independently)
        self._version = 0
        self._update_txn = None
        self._tenant_versions: dict[str, int] = {}
        self._tenant_txns: dict[str, Any] = {}
        # backend-level sliding traffic window ([B, T, L] real-traffic
        # slices) — migration plans from FULL batches, which per-unit
        # windows (sliced tables, sliced replicas) cannot reconstruct
        self.window: deque = deque(maxlen=16)

    # -- descriptor ---------------------------------------------------------
    def capabilities(self) -> StorageCapabilities:
        # mirrors TieredStorage: closed async workers cannot stage again,
        # so staging capabilities drop after close(). Live prefetch depth
        # (not the built config) decides stageability — the queue-depth
        # auto-tuner may have moved it.
        stageable = bool(self.shards) and all(
            ps.prefetch.depth > 0
            and not getattr(ps.prefetch, "closed", False)
            for ps in self.shards)
        return StorageCapabilities(
            device_resident=False,
            stageable=stageable,
            async_prefetch=stageable and all(
                ps.cfg.async_prefetch for ps in self.shards),
            refreshable=True,
            shardable=True,
            tunable=bool(self.shards),
            migratable=bool(self.shards),
            degradable=bool(self.shards),
            fused_lookup=bool(self.shards) and all(
                ps.supports_fused() for ps in self.shards),
            updatable=bool(self.shards))

    @property
    def num_shards(self) -> int:
        return 0 if self.placement is None else self.placement.num_shards

    # -- construction -------------------------------------------------------
    def _resolve_placement(self, placement, num_shards: int,
                           trace: Optional[np.ndarray]) -> ShardPlacement:
        return resolve_placement(self.cfg, placement, num_shards, trace)

    def _construct_units(self, plc: ShardPlacement, tables: np.ndarray,
                         ps_cfg, trace: Optional[np.ndarray] = None,
                         hot_plans: Optional[dict] = None,
                         tenants: Optional[dict] = None
                         ) -> tuple[list[_Unit], list[list[_Unit]]]:
        """Build every unit's ParameterServer for `plc` WITHOUT touching
        any live state — the shared build-before-teardown machinery of
        `build()` and `install_migration()`. A constructor failure here
        raises with nothing torn down and nothing leaked (units already
        constructed are closed again).

        With `tenants` ({name: TenantNamespace}), each shard's solo group
        splits into one unit PER TENANT: a ParameterServer asserts
        full-table coverage on every lookup, so serving tenants
        independently requires units that never mix them. Replica units
        are single-table, hence tenant-pure already — they just get
        tagged."""
        from repro_torch.ps import ParameterServer
        units: list[_Unit] = []
        device = self.ebc.device
        shard_units: list[list[_Unit]] = [[] for _ in range(plc.num_shards)]

        def owner_of(t: int) -> Optional[TenantNamespace]:
            if not tenants:
                return None
            for ns in tenants.values():
                if ns.owns(t):
                    return ns
            raise ValueError(f"table {t} belongs to no tenant namespace")

        def add_unit(shard, ids, chunk, ns=None):
            ids = np.asarray(ids, np.int64)
            # tables[ids] copies the unit's tables: a migration rebuilds
            # units from the authoritative copy, which updates keep current
            if hot_plans is not None:
                plans = [hot_plans[int(t)] for t in ids]
                ps = ParameterServer(tables[ids], ps_cfg, plans=plans,
                                     device=device)
            else:
                ps = ParameterServer(
                    tables[ids], ps_cfg,
                    trace=None if trace is None else trace[:, ids],
                    device=device)
            unit = _Unit(shard=shard, table_ids=ids, ps=ps, chunk=chunk,
                         tenant=None if ns is None else ns.name,
                         cols=None if ns is None else ns.local(ids))
            units.append(unit)
            shard_units[shard].append(unit)

        try:
            for s, tabs in enumerate(plc.shard_tables):
                solo = [t for t in tabs if len(plc.replicas[t]) == 1]
                if tenants:
                    groups: dict[str, list[int]] = {}
                    for t in solo:
                        groups.setdefault(owner_of(t).name, []).append(t)
                    for name, ids in groups.items():
                        add_unit(s, ids, None, tenants[name])
                elif solo:
                    add_unit(s, solo, None)
            for t in plc.replicated_tables:
                owners = plc.replicas[t]
                for k, s in enumerate(owners):
                    add_unit(s, [t], (k, len(owners)), owner_of(t))
        except BaseException:
            for u in units:               # don't leak worker threads
                u.ps.close()
            raise
        return units, shard_units

    def _install_units(self, plc: ShardPlacement, units: list[_Unit],
                       shard_units: list[list[_Unit]]) -> None:
        """Swap fully-constructed units in (serving thread only): close the
        old units AFTER the new ones take over, resize the shard pool only
        when the shard count moved, reset routers to the new replica sets."""
        # anything that can raise runs BEFORE the first assignment — the
        # swap below must be all-or-nothing
        routers = {t: ReplicaRouter(len(plc.replicas[t]))
                   for t in plc.replicated_tables}
        old_units, old_pool_shards = self._units, len(self._shard_units)
        self.placement = plc
        self._units, self._shard_units = units, shard_units
        self.shards = [u.ps for u in units]
        self._routers = routers
        self._epoch += 1
        self._closed = False

        # legacy view: table_slices only describes replication-free
        # placements where every shard owns one ascending contiguous run
        self.table_slices = []
        if not plc.replicated_tables:
            runs = []
            for tabs in plc.shard_tables:
                if tabs and list(tabs) == list(range(tabs[0],
                                                     tabs[-1] + 1)):
                    runs.append(slice(tabs[0], tabs[-1] + 1))
            if (len(runs) == plc.num_shards
                    and all(a.stop == b.start
                            for a, b in zip(runs, runs[1:]))
                    and runs[0].start == 0
                    and runs[-1].stop == self.cfg.num_tables):
                self.table_slices = runs

        # freshly constructed units default to exact serving; a swap that
        # lands mid-overload must come up in the SAME mode the backend is
        # publishing, or one migration would silently lift degradation
        if self._degraded:
            for u in units:
                u.ps.set_degraded(True)
        for u in old_units:               # teardown LAST (swap is done)
            u.ps.close()
        if self._pool is not None and old_pool_shards != plc.num_shards:
            self._pool.shutdown(wait=True)
            self._pool = None
            if plc.num_shards > 1:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=plc.num_shards, thread_name_prefix="ps-shard")

    def build(self, ps_cfg=None, trace: Optional[np.ndarray] = None, *,
              num_shards: int = 2,
              placement: Union[str, ShardPlacement, None] = None,
              device_budget_bytes: Optional[int] = None,
              parallel: bool = True,
              migration_threshold: Optional[float] = None,
              replicate_factor: float = 0.0,
              tenants: Optional[dict] = None,
              **ps_cfg_overrides) -> "ShardedStorage":
        """Assign the collection's tables to `num_shards` shard workers
        and build one ParameterServer per placement unit (same `PSConfig`
        for all — capacities are per-table, so the config is
        shard-size-agnostic).

        `placement` selects the table-to-shard assignment: `'contiguous'`
        (default; the legacy equal split), `'balanced'` (frequency-aware
        LPT from `trace` — see `repro_torch.storage.placement`), or an
        explicit `ShardPlacement` (arbitrary assignment, replication
        included).
        `trace` [N, T, L] is sliced per unit for hot-set planning; the
        auto-tune path (`device_budget_bytes`) plans ONCE on the full
        trace, exactly as the single tiered backend would. `parallel=False`
        disables the shard thread pool (serial fan-out; deterministic
        debugging).

        `migration_threshold` (imbalance ratio, e.g. 1.25) arms live
        migration: `plan_refresh`/`plan_migration` then re-plan the
        placement from the live traffic window and emit a migration plan
        once the serving placement's live imbalance exceeds it.
        `replicate_factor` forwards to the re-planner so a migration may
        also add/remove replicas of a dominant table.

        `tenants` ({name: table_count}, declaration order = contiguous
        layout, counts must tile the table axis) turns on multi-tenant
        mode: tenant-pure units, `tenant_*` verbs, tenant-shaped stats,
        migration disabled. See the module docstring.

        Rebuild-safe: on a live backend every new ParameterServer is
        constructed BEFORE the old units tear down, so a constructor
        failure (bad trace shape, exploding config) leaves the old shards
        serving — the same swap machinery `install_migration` uses."""
        cfg = self.cfg
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        num_shards = min(num_shards, cfg.num_tables)
        trace = _as_numpy(trace)
        ps_cfg = build_ps_config(trace, cfg.rows, cfg.dim,
                                 cfg.torch_dtype.itemsize, ps_cfg,
                                 device_budget_bytes, **ps_cfg_overrides)
        # the host tensor's bytes, not a copy (the tiered backend's law)
        tables = self.ebc.tables[:cfg.num_tables].numpy()
        # everything that can raise runs BEFORE the old backend is touched:
        # placement resolution AND full unit construction — a rejected or
        # failed rebuild must leave the old shards serving
        spaces = (resolve_tenants(tenants, cfg.num_tables)
                  if tenants else {})
        if spaces and migration_threshold is not None:
            raise ValueError("migration is disabled under tenancy (the "
                             "arbiter re-splits capacity instead) — drop "
                             "migration_threshold or tenants")
        plc = self._resolve_placement(placement, num_shards, trace)
        units, shard_units = self._construct_units(plc, tables, ps_cfg,
                                                   trace=trace,
                                                   tenants=spaces or None)
        had_pool = self._pool is not None
        self._degraded = False        # a full (re)build starts exact
        self._install_units(plc, units, shard_units)
        self._tenants = spaces
        self._tenant_hints = {}
        self._tenant_degraded = {name: False for name in spaces}
        self._tables = tables
        # a (re)build installs params' weights wholesale: version restarts
        # at 0 and any buffered transaction dies with the old units
        self._version = 0
        self._update_txn = None
        self._tenant_versions = {name: 0 for name in spaces}
        self._tenant_txns = {}
        self._ps_cfg = ps_cfg
        self.migration_threshold = migration_threshold
        self._replicate_factor = float(replicate_factor)
        self.window = deque(maxlen=ps_cfg.window_batches)
        self._valid_hint = None
        if parallel and plc.num_shards > 1:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=plc.num_shards,
                    thread_name_prefix="ps-shard")
        elif not parallel and had_pool and self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        return self

    def _require_built(self) -> None:
        if self._closed:
            raise RuntimeError(
                "storage='sharded' backend is closed (its shard workers "
                "are joined) — build() it again before serving")
        if not self.shards:
            raise RuntimeError(
                "storage='sharded' needs its shard servers: call "
                "ebc.storage.build(ps_cfg, num_shards=N) first")

    def _reject_under_tenancy(self, verb: str) -> None:
        if self._tenants:
            raise RuntimeError(
                f"this backend has tenants attached "
                f"({sorted(self._tenants)}) — whole-backend {verb}() is "
                f"undefined under tenancy; serve each tenant through its "
                f"TenantStorage view (tenant_{verb})")

    def _ns(self, name: str) -> TenantNamespace:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r}; attached tenants: "
                f"{sorted(self._tenants)}") from None

    def _tenant_by_shard(self, name: str) -> list[list[_Unit]]:
        self._ns(name)
        return [[u for u in g if u.tenant == name]
                for g in self._shard_units]

    def _map_shards(self, fn) -> list:
        """Apply fn(shard_index) across shards — via the pool when one
        exists — and join in shard order. One in-flight call per shard (a
        shard runs its units serially), so each PS keeps its single-caller
        contract."""
        n = len(self._shard_units)
        if self._pool is None:
            return [fn(s) for s in range(n)]
        futs = [self._pool.submit(fn, s) for s in range(n)]
        return [f.result() for f in futs]

    def _unit_bounds(self, u: _Unit, batch: int) -> tuple[int, int]:
        """The batch rows unit `u` serves: the full batch for a shard's
        non-replicated group, or its replica's routed slice — the
        table's `ReplicaRouter` cut (equal `np.array_split` law until the
        router has observations). lookup/stage/hint all route through
        here, so staged indices always match the upcoming lookup's."""
        if u.chunk is None:
            return 0, batch
        k, r = u.chunk
        router = self._routers.get(int(u.table_ids[0]))
        if router is not None:
            b = router.bounds(batch)
            return int(b[k]), int(b[k + 1])
        return _chunk_bounds(batch, r, k)

    # -- data path ----------------------------------------------------------
    def _fan_lookup(self, by_shard: list[list[_Unit]], idx: np.ndarray,
                    weights, valid: Optional[int], T: int) -> torch.Tensor:
        """Fan a [B, T, L] lookup out over `by_shard`'s units, join, and
        put the per-unit blocks together on the device — bit-identical to
        the single-server tiered path. Each unit's `cols` maps its tables
        onto the CALLER's batch columns, so the same fan-out serves
        whole-backend lookups (cols == global ids) and tenant-local
        lookups (cols == namespace-local). Replica units are timed
        (service seconds over routed rows) to feed the router."""
        B, _, L = idx.shape
        flat = [u for g in by_shard for u in g]
        dtype = flat[0].ps.cold.tables.dtype
        dim = flat[0].ps.cold.dim
        device = self.ebc.device
        w_np = _as_numpy(weights)
        fused_path = all(u.ps.supports_fused() for u in flat)

        def serve(u: _Unit, lo: int, hi: int):
            if valid is not None:
                u.ps.hint_valid(int(np.clip(valid - lo, 0, hi - lo)))
            block = idx[lo:hi][:, u.cols]
            if not fused_path:
                return u.ps.lookup(block)                # [b, t, L, D]
            # one fused launch over this unit's tables; its mean epilogue
            # divides by the same L, so each bag is pooled as a single
            # fused server pools it
            return u.ps.lookup_fused(
                block, None if w_np is None else w_np[lo:hi][:, u.cols],
                combine=self.cfg.combine)

        def run_shard(s):
            done = []
            for u in by_shard[s]:
                lo, hi = self._unit_bounds(u, B)
                if lo == hi:
                    continue
                if u.chunk is not None:
                    t0 = time.perf_counter()
                    out = serve(u, lo, hi)
                    u.service_s += time.perf_counter() - t0
                    u.served_rows += hi - lo
                else:
                    out = serve(u, lo, hi)
                done.append((u, lo, hi, out))
            return done

        blocks = [b for done in self._map_shards(run_shard) for b in done]
        if fused_path:
            # each unit's pooled [b, t, D] block lands at rows lo:hi and
            # columns cols of one output on the device, never via the host
            pooled_out = torch.empty((B, T, dim), device=device,
                                     dtype=self.cfg.torch_dtype)
            for u, lo, hi, pooled in blocks:
                pooled_out[lo:hi].index_copy_(
                    1, torch.from_numpy(u.cols).to(device), pooled)
            return pooled_out
        out = np.empty((B, T, L, dim), dtype)
        for u, lo, hi, rows in blocks:
            out[lo:hi, u.cols] = rows
        # pooled once on the device, each bag as the device backend pools
        # it (the tiered backend's per-row path)
        w = None if w_np is None else np.asarray(
            w_np, np.float32).reshape(B * T, L)
        pooled = fused.pool_bag_rows(out.reshape(B * T, L, dim), w,
                                     mode=self.cfg.combine, device=device)
        return pooled.view(B, T, dim)

    def lookup(self, indices, weights=None, *,
               pre_remapped: bool = False) -> torch.Tensor:
        """Whole-backend [B, T, L] lookup; the real-traffic slice lands in
        the backend window that migration plans from. Undefined under
        tenancy — serve through the per-tenant views instead."""
        self._require_built()
        self._reject_under_tenancy("lookup")
        idx = _as_numpy(indices)
        valid, self._valid_hint = self._valid_hint, None
        real = idx if valid is None else idx[:valid]
        if real.shape[0]:
            self.window.append(real)
        return self._fan_lookup(self._shard_units, idx, weights, valid,
                                idx.shape[1])

    # -- prefetch -----------------------------------------------------------
    def can_stage(self) -> bool:
        """All-shards backpressure: staging only fires when every unit has
        a free queue slot, keeping the shard queues in lockstep (a staged
        batch is either resident on all shards or on none)."""
        return bool(self.shards) and all(ps.can_stage()
                                         for ps in self.shards)

    def _fan_stage(self, by_shard: list[list[_Unit]],
                   idx: np.ndarray) -> bool:
        B = idx.shape[0]

        def run_shard(s):
            ok = True
            for u in by_shard[s]:
                lo, hi = self._unit_bounds(u, B)
                if lo == hi:
                    continue
                ok &= u.ps.stage(idx[lo:hi, u.cols])
            return ok

        return all(self._map_shards(run_shard))

    def stage(self, next_indices: np.ndarray) -> bool:
        self._require_built()
        self._reject_under_tenancy("stage")
        return self._fan_stage(self._shard_units, _as_numpy(next_indices))

    def hint_valid(self, n: int) -> None:
        """Recorded here and applied per unit at the next lookup (replica
        units see the hint clipped to their batch slice)."""
        self._valid_hint = int(n)

    # -- degraded (warm-cache-only) overload mode ----------------------------
    def degraded(self) -> bool:
        return self._degraded

    def set_degraded(self, on: bool) -> bool:
        """Fan the mode toggle out to every unit in lockstep (matching the
        all-shards staging law: a batch is answered degraded by all units
        or by none). The backend-level flag makes the mode survive a
        migration swap — `_install_units` re-applies it to fresh units."""
        if not self.shards:
            return False
        self._degraded = bool(on)
        for ps in self.shards:
            ps.set_degraded(on)
        for name in self._tenant_degraded:   # keep per-tenant flags honest
            self._tenant_degraded[name] = bool(on)
        return True

    # -- refresh ------------------------------------------------------------
    def refresh_window(self) -> dict:
        """Snapshot taken on the serving thread: per-unit windows (hot-set
        re-planning), the backend-level full-batch window (migration
        re-planning), and the unit epoch so a plan raced by a migration
        swap is detected at install time instead of misapplied."""
        return {"units": [list(ps.window) for ps in self.shards],
                "traffic": list(self.window),
                "epoch": self._epoch}

    def plan_refresh(self, window=None):
        """Pure planning; helper-thread safe (reads only the snapshot).

        Plans each unit's hot-set refresh and — when a
        `migration_threshold` was configured at build — also re-plans the
        placement from the full-batch window ("placement re-planning at
        refresh time"). Returns None when there is nothing to do."""
        self._require_built()
        if window is None:
            window = self.refresh_window()
        if isinstance(window, list):          # legacy per-unit-only shape
            window = {"units": window, "traffic": [],
                      "epoch": self._epoch}
        unit_plans = None
        if window["epoch"] == self._epoch and \
                len(window["units"]) == len(self.shards):
            plans = [ps.plan_refresh(w)
                     for ps, w in zip(self.shards, window["units"])]
            if any(p is not None for p in plans):
                unit_plans = plans
        migration = None
        if self.migration_threshold is not None:
            migration = self.plan_migration(window)
        if unit_plans is None and migration is None:
            return None
        return {"units": unit_plans, "migration": migration,
                "epoch": window["epoch"]}

    def install_refresh(self, plan) -> dict:
        self._require_built()
        if plan is None:
            results = [ps.install_refresh(None) for ps in self.shards]
            return {"replanned": False,
                    "refreshes": max(r["refreshes"] for r in results)}
        if isinstance(plan, list):            # legacy per-unit-only shape
            plan = {"units": plan, "migration": None, "epoch": self._epoch}
        if plan.get("migration") is not None:
            # the swap rebuilds every unit with hot plans from the same
            # window, superseding the (now unit-less) per-unit plans
            result = self.install_migration(plan["migration"])
            result["replanned"] = result.get("migrated", False)
            result.setdefault(
                "refreshes", max((ps.refreshes for ps in self.shards),
                                 default=0))
            return result
        if plan["epoch"] != self._epoch or \
                plan["units"] is None or \
                len(plan["units"]) != len(self.shards):
            # planned against units that no longer exist (migration or
            # rebuild raced the helper thread): drop it, next cycle re-plans
            return {"replanned": False,
                    "refreshes": max((ps.refreshes for ps in self.shards),
                                     default=0)}
        results = [ps.install_refresh(p)
                   for ps, p in zip(self.shards, plan["units"])]
        return {"replanned": any(r["replanned"] for r in results),
                "refreshes": max(r["refreshes"] for r in results)}

    def refresh(self) -> dict:
        return self.install_refresh(self.plan_refresh())

    # -- live migration & routing -------------------------------------------
    def update_routing(self) -> Optional[dict]:
        """Fold the window's per-replica service costs (seconds per routed
        batch row, straight off the shard workers' lookup timers) into
        each replicated table's `ReplicaRouter` and reset the
        accumulators. A table whose published split moved gets its replica
        units' staged prefetch batches flushed — they were cut at the old
        bounds and would never match a routed lookup again (stale entries
        would pin queue slots forever). Units whose slices are unaffected
        (solo units, replicas of unmoved tables) keep theirs: `bounds()`
        is a pure function of the published split, which changes exactly
        when `observe()` says so. Returns None when the placement has no
        replicas; else `{"changed": bool, "fractions": {table: [...]}}`."""
        if not self._routers:
            return None
        self._require_built()
        changed_tables = []
        fractions = {}
        for t, router in self._routers.items():
            units = sorted((u for u in self._units
                            if u.chunk is not None
                            and int(u.table_ids[0]) == t),
                           key=lambda u: u.chunk[0])
            costs = np.array([u.service_s / u.served_rows
                              if u.served_rows else np.nan for u in units])
            for u in units:
                u.service_s, u.served_rows = 0.0, 0
            if router.observe(costs):
                changed_tables.append(t)
            fractions[t] = [round(float(f), 4) for f in router.fractions()]
        for u in self._units:
            if u.chunk is not None and int(u.table_ids[0]) in changed_tables:
                u.ps.prefetch.flush()
        return {"changed": bool(changed_tables), "fractions": fractions}

    def plan_migration(self, window: Any = None, *,
                       threshold: Optional[float] = None
                       ) -> Optional[dict]:
        """Phase 1 (pure, helper-thread safe): re-plan the placement from
        the live full-batch window. Returns None unless the serving
        placement's imbalance under the LIVE loads exceeds `threshold`
        (default: the build-time `migration_threshold`, else
        `DEFAULT_MIGRATION_THRESHOLD`) and the re-planned placement wins
        materially. The plan carries per-table hot plans computed from the
        same window, so `install_migration` only constructs and swaps."""
        self._require_built()
        if self._tenants:
            # under tenancy fairness is the arbiter's job; a placement
            # move would have to preserve tenant-purity anyway
            return None
        if window is None:
            # only the backend-level full-batch window is needed — don't
            # snapshot every unit's per-PS window (refresh_window) just
            # to discard it
            window = {"traffic": list(self.window), "epoch": self._epoch}
        traffic = window["traffic"] if isinstance(window, dict) else window
        if not traffic:
            return None
        trace = np.concatenate(
            [w.reshape(w.shape[0], w.shape[1], -1) for w in traffic],
            axis=0)                                       # [N, T, L]
        if threshold is None:
            threshold = (self.migration_threshold
                         if self.migration_threshold is not None
                         else DEFAULT_MIGRATION_THRESHOLD)
        mig = plan_migration(
            self.placement, trace,
            row_bytes=self.cfg.dim * self.cfg.torch_dtype.itemsize,
            threshold=threshold,
            replicate_factor=self._replicate_factor)
        if mig is None:
            return None
        hot_plans = None
        k = min(self._ps_cfg.hot_rows, self.cfg.rows)
        if k > 0:
            from repro_torch.core import hot_cache
            hot_plans = {t: hot_cache.plan_from_trace(trace[:, t],
                                                      self.cfg.rows, k)
                         for t in range(self.cfg.num_tables)}
        return {"migration": mig, "hot_plans": hot_plans}

    def install_migration(self, plan: Optional[dict]) -> dict:
        """Phase 2 (serving thread only): apply a `plan_migration` result
        build-before-teardown. Every new unit's ParameterServer is fully
        constructed FIRST; only after the atomic swap do the orphaned old
        units close — so a constructor failure (or a None/stale plan)
        always leaves the old backend serving, bit-exactly. Old units'
        staged batches and warm-cache contents die with them (the new
        units re-admit from traffic; served values never change)."""
        self._require_built()
        if plan is None:
            return {"migrated": False}
        mig: MigrationPlan = plan["migration"]
        if mig.old.replicas != self.placement.replicas or \
                mig.old.num_shards != self.placement.num_shards:
            # planned against a placement that already changed: reject
            return {"migrated": False, "stale_plan": True}
        units, shard_units = self._construct_units(
            mig.new, self._tables, self._ps_cfg,
            hot_plans=plan.get("hot_plans"))
        self._install_units(mig.new, units, shard_units)
        return {"migrated": True,
                "moved_tables": list(mig.moved_tables),
                "replica_changes": list(mig.replica_changes),
                "imbalance_before": round(mig.imbalance_before, 4),
                "imbalance_after": round(mig.imbalance_after, 4)}

    # -- online model updates ------------------------------------------------
    def version(self) -> int:
        return self._version

    def begin_update(self, version: int) -> bool:
        from repro_torch.core.update import UpdateTxn
        self._require_built()
        self._reject_under_tenancy("begin_update")
        if self._update_txn is not None:
            raise RuntimeError(
                f"an update to v{self._update_txn.version} is already "
                f"open — commit or abort it first")
        self._update_txn = UpdateTxn(version, self._version)
        return True

    def apply_update(self, table: int, rows, values) -> bool:
        from repro_torch.core.update import require_open
        require_open(self._update_txn, "apply_update").add(
            table, rows, values, num_tables=self.cfg.num_tables,
            num_rows=self.cfg.rows, dim=self.cfg.dim,
            dtype=self._tables.dtype)
        return True

    def _commit_units(self, units: list[_Unit], merged: dict) -> int:
        """Fan committed rows to every unit owning a touched table —
        replicas included (each copy must take the new bytes).

        All-units-or-none by construction: the per-unit local payloads
        are computed FIRST (pure — anything that can raise, raises here
        with no unit touched), and only then does the install loop run,
        which is plain tier maintenance that cannot fail — the same
        validate-before-mutate shape `_construct_units`/`_install_units`
        give migration."""
        per_unit = []
        for u in units:
            index_of = {int(t): i for i, t in enumerate(u.table_ids)}
            local = {index_of[int(t)]: payload
                     for t, payload in merged.items()
                     if int(t) in index_of}
            per_unit.append(local)
        touched = 0
        for u, local in zip(units, per_unit):
            if local:
                u.ps._install_update_rows(local)
                touched += 1
        return touched

    def _write_authoritative(self, merged: dict) -> None:
        """The backend-level table copy migration rebuilds units from
        must carry the new bytes too — otherwise the next swap would
        silently roll the weights back."""
        if not self._tables.flags.writeable:
            self._tables = self._tables.copy()
        for t, (rows, vals) in merged.items():
            self._tables[t, rows] = vals

    def commit_update(self, version: int) -> dict:
        from repro_torch.core.update import require_open
        self._require_built()
        self._reject_under_tenancy("commit_update")
        txn = require_open(self._update_txn, "commit_update")
        txn.check_commit(version)
        merged = txn.merged()
        units = self._commit_units(self._units, merged)
        self._write_authoritative(merged)
        self._version = txn.version
        self._update_txn = None
        return {"updated": True, "version": self._version,
                "rows": txn.rows, "tables": len(merged), "units": units}

    def abort_update(self, version: int) -> bool:
        if self._update_txn is None:
            return False
        self._update_txn.check_commit(version)
        self._update_txn = None
        return True

    # tenant-scoped updates: each tenant runs its own version counter and
    # transaction over ITS namespace — tenants upgrade independently, and
    # sibling units are never touched (same isolation law as attach/detach)
    def tenant_version(self, name: str) -> int:
        self._ns(name)
        return self._tenant_versions.get(name, 0)

    def tenant_begin_update(self, name: str, version: int) -> bool:
        from repro_torch.core.update import UpdateTxn
        self._require_built()
        self._ns(name)
        if name in self._tenant_txns:
            raise RuntimeError(
                f"tenant {name!r} already has an update open to "
                f"v{self._tenant_txns[name].version}")
        self._tenant_txns[name] = UpdateTxn(
            version, self._tenant_versions.get(name, 0))
        return True

    def tenant_apply_update(self, name: str, table: int, rows,
                            values) -> bool:
        from repro_torch.core.update import require_open
        ns = self._ns(name)
        require_open(self._tenant_txns.get(name),
                     f"tenant {name!r} apply_update").add(
            table, rows, values, num_tables=ns.num_tables,
            num_rows=self.cfg.rows, dim=self.cfg.dim,
            dtype=self._tables.dtype)
        return True

    def tenant_commit_update(self, name: str, version: int) -> dict:
        from repro_torch.core.update import require_open
        self._require_built()
        ns = self._ns(name)
        txn = require_open(self._tenant_txns.get(name),
                           f"tenant {name!r} commit_update")
        txn.check_commit(version)
        # tenant-local table ids -> global, then the standard unit fan-out
        # restricted to THIS tenant's units
        merged = {ns.start + t: payload
                  for t, payload in txn.merged().items()}
        units = self._commit_units(self._tenant_units(name), merged)
        self._write_authoritative(merged)
        self._tenant_versions[name] = txn.version
        del self._tenant_txns[name]
        return {"updated": True, "tenant": name, "version": txn.version,
                "rows": txn.rows, "tables": len(merged), "units": units}

    def tenant_abort_update(self, name: str, version: int) -> bool:
        self._ns(name)
        txn = self._tenant_txns.get(name)
        if txn is None:
            return False
        txn.check_commit(version)
        del self._tenant_txns[name]
        return True

    # -- runtime tuning ------------------------------------------------------
    def prefetch_depth(self) -> int:
        return max((ps.prefetch.depth for ps in self.shards), default=0)

    def set_prefetch_depth(self, depth: int) -> bool:
        """Move every unit's bounded prefetch buffer to `depth` (lockstep,
        matching the all-shards staging backpressure)."""
        if not self.shards:
            return False
        for ps in self.shards:
            ps.set_prefetch_depth(depth)
        return True

    def take_prefetch_window_peak(self) -> int:
        return max((ps.prefetch.take_window_peak() for ps in self.shards),
                   default=0)

    def retune_capacities(self, budget_bytes: int) -> Optional[dict]:
        """Re-split a LIVE device-byte budget into per-unit hot/warm
        capacities from each unit's traffic window. The budget divides
        across units by table count (capacities are per-table), so the
        whole backend stays within it."""
        self._require_built()
        total_tables = sum(len(u.table_ids) for u in self._units)
        results = []
        for u in self._units:
            share = int(budget_bytes * len(u.table_ids) / total_tables)
            results.append(u.ps.retune(share))
        done = [r for r in results if r is not None]
        if not done:
            return None
        return {"retuned_units": len(done),
                "hot_rows": max(r["hot_rows"] for r in done),
                "warm_slots": max(r["warm_slots"] for r in done),
                "budget_bytes": int(budget_bytes)}

    def _unit_device_bytes(self, u: _Unit) -> int:
        """Device-resident cache footprint of one unit: the hot block
        ([T, K, D] pin) plus the warm payload (warm_slots rows per
        table). Cold rows live on host and don't count."""
        ps = u.ps
        return int((ps.num_hot + ps.cfg.warm_slots)
                   * ps.cold.num_tables * ps.cold.dim
                   * ps.cold.tables.dtype.itemsize)

    def device_bytes(self) -> int:
        return sum(self._unit_device_bytes(u) for u in self._units)

    # -- tenancy ------------------------------------------------------------
    @property
    def tenants(self) -> dict:
        """Attached tenant namespaces, {name: TenantNamespace} (copy)."""
        return dict(self._tenants)

    def _tenant_units(self, name: str) -> list[_Unit]:
        self._ns(name)
        return [u for u in self._units if u.tenant == name]

    def tenant_lookup(self, name: str, indices, weights=None):
        """One tenant's [B, T_tenant, L] lookup over its own units —
        the same fan-out/scatter/pool as `lookup()`, just restricted to
        tenant-pure units with namespace-local columns. Pooling divides
        by THIS batch's L (tenants may use different bag sizes)."""
        self._require_built()
        idx = _as_numpy(indices)
        by_shard = self._tenant_by_shard(name)
        valid = self._tenant_hints.pop(name, None)
        return self._fan_lookup(by_shard, idx, weights, valid,
                                idx.shape[1])

    def tenant_stage(self, name: str, next_indices) -> bool:
        self._require_built()
        return self._fan_stage(self._tenant_by_shard(name),
                               _as_numpy(next_indices))

    def tenant_can_stage(self, name: str) -> bool:
        units = self._tenant_units(name)
        return bool(units) and all(u.ps.can_stage() for u in units)

    def tenant_hint_valid(self, name: str, n: int) -> None:
        self._ns(name)
        self._tenant_hints[name] = int(n)

    def tenant_refresh_window(self, name: str) -> dict:
        return {"units": [list(u.ps.window)
                          for u in self._tenant_units(name)],
                "epoch": self._epoch}

    def tenant_plan_refresh(self, name: str, window=None):
        self._require_built()
        if window is None:
            window = self.tenant_refresh_window(name)
        units = self._tenant_units(name)
        if window["epoch"] != self._epoch or \
                len(window["units"]) != len(units):
            return None
        plans = [u.ps.plan_refresh(w)
                 for u, w in zip(units, window["units"])]
        if all(p is None for p in plans):
            return None
        return {"units": plans, "epoch": window["epoch"]}

    def tenant_install_refresh(self, name: str, plan) -> dict:
        self._require_built()
        units = self._tenant_units(name)
        if plan is None or plan["epoch"] != self._epoch or \
                len(plan["units"]) != len(units):
            results = [u.ps.install_refresh(None) for u in units]
            return {"replanned": False,
                    "refreshes": max((r["refreshes"] for r in results),
                                     default=0)}
        results = [u.ps.install_refresh(p)
                   for u, p in zip(units, plan["units"])]
        return {"replanned": any(r["replanned"] for r in results),
                "refreshes": max(r["refreshes"] for r in results)}

    def tenant_prefetch_depth(self, name: str) -> int:
        return max((u.ps.prefetch.depth for u in self._tenant_units(name)),
                   default=0)

    def tenant_set_prefetch_depth(self, name: str, depth: int) -> bool:
        units = self._tenant_units(name)
        for u in units:
            u.ps.set_prefetch_depth(depth)
        return bool(units)

    def tenant_take_prefetch_window_peak(self, name: str) -> int:
        return max((u.ps.prefetch.take_window_peak()
                    for u in self._tenant_units(name)), default=0)

    def tenant_retune_capacities(self, name: str,
                                 budget_bytes: int) -> Optional[dict]:
        """Re-split ONE TENANT's slice of the shared device budget across
        its units (by table count, same law as the whole-backend
        retune). The arbiter calls this once per tenant with shares that
        sum to ≤ the shared budget, so the backend total stays within
        it."""
        self._require_built()
        units = self._tenant_units(name)
        total_tables = sum(len(u.table_ids) for u in units)
        if not total_tables:
            return None
        results = []
        for u in units:
            share = int(budget_bytes * len(u.table_ids) / total_tables)
            results.append(u.ps.retune(share))
        done = [r for r in results if r is not None]
        if not done:
            return None
        return {"tenant": name,
                "retuned_units": len(done),
                "hot_rows": max(r["hot_rows"] for r in done),
                "warm_slots": max(r["warm_slots"] for r in done),
                "budget_bytes": int(budget_bytes)}

    def tenant_device_bytes(self, name: str) -> int:
        return sum(self._unit_device_bytes(u)
                   for u in self._tenant_units(name))

    def tenant_degraded(self, name: str) -> bool:
        self._ns(name)
        return self._tenant_degraded.get(name, False)

    def tenant_set_degraded(self, name: str, on: bool) -> bool:
        units = self._tenant_units(name)
        if not units:
            return False
        self._tenant_degraded[name] = bool(on)
        for u in units:
            u.ps.set_degraded(on)
        return True

    def tenant_stats(self, name: str) -> dict:
        """One tenant's merged report (same merge law as the whole
        backend; `per_shard` covers only the shards holding this tenant)
        plus its resident `device_bytes`."""
        per_shard = []
        for g in self._tenant_by_shard(name):
            if not g:
                continue
            if len(g) == 1:
                per_shard.append(g[0].ps.stats())
            else:
                merged = merge_shard_stats([u.ps.stats() for u in g])
                merged.pop("per_shard", None)
                merged.pop("num_shards", None)
                per_shard.append(merged)
        out = merge_shard_stats(per_shard)
        out["tenant"] = name
        out["device_bytes"] = self.tenant_device_bytes(name)
        return out

    def tenant_reset_stats(self, name: str) -> None:
        for u in self._tenant_units(name):
            u.ps.reset_stats()
            u.service_s, u.served_rows = 0.0, 0

    def tenant_flush(self, name: str) -> None:
        for u in self._tenant_units(name):
            u.ps.flush()

    def attach_tenant(self, name: str, tables: np.ndarray, *,
                      trace: Optional[np.ndarray] = None
                      ) -> TenantNamespace:
        """Admit a new tenant mid-serving: build its units FIRST (one per
        shard, its tables split contiguously), then append — no sibling
        unit is touched, moved, or rebuilt, so sibling bit-exactness is
        structural. `tables` is the tenant's [T_new, R, D] stack (same
        rows/dim/dtype as the shared build); `trace` [N, T_new, L] seeds
        its hot plans. The tenant starts with the build-time PSConfig
        capacities; the next arbiter round re-splits the shared budget
        over the new tenant set."""
        from repro_torch.ps import ParameterServer
        self._require_built()
        if not self._tenants:
            raise RuntimeError("attach_tenant needs a backend built with "
                               "tenants={...}")
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} is already attached")
        tables = _as_numpy(tables)
        trace = _as_numpy(trace)
        if tables.ndim != 3 or tables.shape[1] != self.cfg.rows or \
                tables.shape[2] != self.cfg.dim:
            raise ValueError(
                f"tenant tables must be [T, {self.cfg.rows}, "
                f"{self.cfg.dim}], got {tables.shape}")
        if tables.dtype != self._tables.dtype:
            raise ValueError(f"tenant dtype {tables.dtype} != shared "
                             f"{self._tables.dtype}")
        start = int(self._tables.shape[0])
        ns = TenantNamespace(str(name), start, start + tables.shape[0])
        num_shards = len(self._shard_units)
        new_units: list[_Unit] = []
        try:
            for s, ids in enumerate(np.array_split(
                    np.arange(ns.start, ns.stop, dtype=np.int64),
                    num_shards)):
                if not len(ids):
                    continue
                local = ns.local(ids)
                ps = ParameterServer(
                    tables[local], self._ps_cfg,
                    trace=None if trace is None else trace[:, local],
                    device=self.ebc.device)
                new_units.append(_Unit(shard=s, table_ids=ids, ps=ps,
                                       tenant=ns.name, cols=local))
        except BaseException:
            for u in new_units:
                u.ps.close()
            raise
        # commit (serving thread only): append, never reshuffle
        self._tables = np.concatenate([self._tables, tables], axis=0)
        for u in new_units:
            self._units.append(u)
            self._shard_units[u.shard].append(u)
        self.shards = [u.ps for u in self._units]
        self._tenants[ns.name] = ns
        self._tenant_degraded[ns.name] = False
        self._tenant_versions[ns.name] = 0
        self._epoch += 1          # in-flight refresh plans re-plan next cycle
        return ns

    def detach_tenant(self, name: str) -> int:
        """Evict a tenant mid-serving: close ITS units only; siblings keep
        serving the same ParameterServers (namespaces of remaining
        tenants are stable — global table ids are never renumbered).
        Returns the number of units released."""
        self._require_built()
        removed = self._tenant_units(name)    # validates the name
        for u in removed:
            u.ps.close()
        self._units = [u for u in self._units if u.tenant != name]
        self._shard_units = [[u for u in g if u.tenant != name]
                             for g in self._shard_units]
        self.shards = [u.ps for u in self._units]
        del self._tenants[name]
        self._tenant_hints.pop(name, None)
        self._tenant_degraded.pop(name, None)
        self._tenant_versions.pop(name, None)
        self._tenant_txns.pop(name, None)
        self._epoch += 1
        return len(removed)

    # -- stats & hygiene ----------------------------------------------------
    def stats(self) -> dict:
        """One merged report; `per_shard` holds one entry per SHARD (a
        multi-unit shard's units are pre-merged into its entry).

        Under tenancy the report is tenant-scoped instead:
        `{"tenants": {name: merged-per-tenant}, "shared": merged-all}` —
        the shared half is exactly what the flat report would have said,
        so the single-tenant flat shape is its one-key degenerate case."""
        per_shard = []
        for units in self._shard_units:
            if not units:
                continue
            if len(units) == 1:
                per_shard.append(units[0].ps.stats())
            else:
                merged = merge_shard_stats([u.ps.stats() for u in units])
                merged.pop("per_shard", None)
                merged.pop("num_shards", None)
                per_shard.append(merged)
        merged_all = merge_shard_stats(per_shard)
        if not self._tenants:
            return merged_all
        merged_all["device_bytes"] = self.device_bytes()
        merged_all["num_tenants"] = len(self._tenants)
        return {"tenants": {name: self.tenant_stats(name)
                            for name in self._tenants},
                "shared": merged_all}

    def reset_stats(self) -> None:
        for ps in self.shards:
            ps.reset_stats()
        for u in self._units:
            u.service_s, u.served_rows = 0.0, 0

    def flush(self) -> None:
        for ps in self.shards:
            ps.flush()
        self.window.clear()

    def close(self) -> None:
        """Join every unit's workers and the shard pool, then CLEAR the
        unit lists: a closed backend must not pass `_require_built` (its
        prefetch workers are gone — a post-close lookup would die deep in
        a joined queue with an opaque error) nor advertise `tunable`.
        Idempotent; `build()` re-opens."""
        for ps in self.shards:
            ps.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self.shards:
            self._closed = True
        self.shards = []
        self._units = []
        self._shard_units = []
        self._routers = {}
        self._degraded = False
        self._tenants = {}
        self._tenant_hints = {}
        self._tenant_degraded = {}
        self._update_txn = None
        self._tenant_txns = {}
        self.window.clear()
