"""`pool` backend — the sharded tiered store lifted to worker PROCESSES.

`ShardedStorage` fans placement units out over a thread pool inside one
process: shard count is bounded by one GIL and every replica duplicates
its cold rows in the one host heap. `PoolStorage` keeps the exact same
unit decomposition, placement machinery (`ShardPlacement`, migration,
`ReplicaRouter`), and scatter/gather math — but each unit's
`ParameterServer` lives in a real worker process behind the framed RPC of
`repro_torch.storage.pool.transport` (the NVIDIA GPU-specialized inference PS
shape: per-worker device caches over one shared host tier).

What crosses the process boundary, and what doesn't:

  * cold tables — ONE `shared_memory` segment per host, created at
    `build()`; workers map it read-only and contiguous table groups are
    served as zero-copy views, so N workers replicating a hot table share
    one host copy of its rows. Only the per-worker hot/warm device caches
    duplicate — that is the dedup `stats()["pool"]` reports.
  * lookups — per-unit index slices out, per-unit row blocks (or fused
    pooled blocks) back; the pool puts them together as `ShardedStorage`
    does (see below), so `pool` is bit-exact vs `device`/`sharded`/
    `tiered` on every placement, migration, and degraded path.
  * routing & migration state — pool-side, the sharded backend's: routers
    split replicated tables' batches by observed per-replica service cost
    (timed inside the worker, so RPC overhead doesn't pollute the signal),
    and `plan_migration` re-plans from the pool-side full-batch window.

Cross-process build-before-teardown: `install_migration` constructs the
new epoch's units as PENDING on every worker first (`construct_pending`),
then commits everywhere; any construct failure — including a worker
KILLED mid-swap — aborts the pending units on the survivors, respawns the
dead worker with the CURRENT units, and leaves the old pool serving. A
worker crash during normal serving is likewise absorbed: the dead worker
is respawned from the shared tier (its caches restart cold; served values
never change) and only its slice of the batch is retried.

A port of `repro/storage/pool/pool.py`. Where it differs:

  * `build()` takes no params: the segment is filled from the collection's
    host `tables`, which stay the authoritative copy a rebuild reads (a
    committed update writes them as it writes the segment, as the
    `sharded` backend's commit does).
  * Each worker process owns a CUDA context: its units' parameter servers
    live on the collection's device and launch the fused kernel (once a
    unit a lookup) and the embedding-bag kernel (bag completion) there.
    Kernel launch counters are per process, so `worker_status()` carries
    each worker's counts and peak device bytes, and
    `take_worker_launches()` reads and zeroes them. These fields are
    port-only and stay out of `stats()`, whose schema the merge law
    shares with the other backends.
  * The pooled output is put together on the collection's device: a
    unit's fused block crosses the pipe as host numpy and is copied into
    rows lo:hi, columns `cols` of one [B, T, D] tensor with `index_copy_`
    (the `sharded` backend's fan-in); unfused row blocks rebuild the
    [B, T, L, D] buffer that `fused.pool_bag_rows` pools once. Either way
    `pool == sharded == tiered == device`, bit for bit.
  * Hot plans travel as dicts of arrays (shared memory, not the pipe), and
    only the plans of a worker's own tables go to it.
  * Each worker runs with an equal share of the host's cores as its
    intra-op threads.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import os
from collections import deque
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.embedding_bag import fused
from repro_torch.storage.base import EmbeddingStorage, StorageCapabilities
from repro_torch.storage.placement import (DEFAULT_MIGRATION_THRESHOLD,
                                           MigrationPlan, ReplicaRouter,
                                           ShardPlacement, plan_migration)
from repro_torch.storage.pool.transport import (DEFAULT_TIMEOUT,
                                                RemoteCallError,
                                                WorkerDeadError,
                                                create_segment,
                                                spawn_worker)
from repro_torch.storage.registry import register
from repro_torch.storage.sharded import (_chunk_bounds, merge_shard_stats,
                                         resolve_placement)
from repro_torch.storage.tenancy import TenantNamespace, resolve_tenants
from repro_torch.storage.tiered import (_as_numpy, _reject_double_remap,
                                        build_ps_config)
from repro_torch.utils import host_array, to_tensor


def _wire_plans(plans: Optional[dict], table_ids) -> Optional[dict]:
    """{table: HotPlan} -> the plans of `table_ids` as plain dicts (their
    arrays ride shared memory), or None when there are no plans."""
    if plans is None:
        return None
    return {int(t): dataclasses.asdict(plans[int(t)]) for t in table_ids}


@dataclasses.dataclass
class _RemoteUnit:
    """Pool-side mirror of one worker-hosted ParameterServer unit — the
    same placement coordinates as `ShardedStorage._Unit`, with the PS
    replaced by (worker, unit_id) routing. Under tenancy a unit is
    tenant-pure: `tenant` names its owner and `cols` maps `table_ids`
    onto the caller-batch columns (tenant-local for tenant units)."""
    unit_id: int
    shard: int
    worker: int
    table_ids: np.ndarray                 # global table ids, ascending
    chunk: Optional[tuple[int, int]] = None
    service_s: float = 0.0                # replica units: window lookup time
    served_rows: int = 0                  # replica units: window batch rows
    tenant: Optional[str] = None
    cols: Optional[np.ndarray] = None     # caller-batch columns

    def __post_init__(self):
        if self.cols is None:
            self.cols = self.table_ids

    def spec(self, device: str) -> dict:
        """The construction descriptor shipped to the worker (tenancy is
        a pool-side concept — the worker only needs global table ids for
        its shared-segment views), with the device its server lives on."""
        return {"unit_id": self.unit_id, "shard": self.shard,
                "table_ids": self.table_ids, "chunk": self.chunk,
                "device": device}


def _plan_units(plc: ShardPlacement, num_workers: int,
                tenants: Optional[dict] = None
                ) -> tuple[list[_RemoteUnit], list[list[_RemoteUnit]]]:
    """Enumerate placement units in `ShardedStorage._construct_units`
    order and assign each to a worker by shard (`shard % num_workers`).
    Replicas of one table live on distinct shards by placement invariant,
    so with workers >= shards they land on distinct processes.

    With `tenants` ({name: TenantNamespace}) each shard's solo group
    splits per tenant (a ParameterServer asserts full-table coverage, so
    tenant-independent serving needs tenant-pure units); replica units
    are single-table and just get tagged."""
    units: list[_RemoteUnit] = []
    by_worker: list[list[_RemoteUnit]] = [[] for _ in range(num_workers)]

    def owner_of(t: int) -> Optional[TenantNamespace]:
        if not tenants:
            return None
        for ns in tenants.values():
            if ns.owns(t):
                return ns
        raise ValueError(f"table {t} belongs to no tenant namespace")

    def add(shard: int, ids, chunk, ns=None) -> None:
        ids = np.asarray(ids, np.int64)
        u = _RemoteUnit(unit_id=len(units), shard=shard,
                        worker=shard % num_workers,
                        table_ids=ids, chunk=chunk,
                        tenant=None if ns is None else ns.name,
                        cols=None if ns is None else ns.local(ids))
        units.append(u)
        by_worker[u.worker].append(u)

    for s, tabs in enumerate(plc.shard_tables):
        solo = [t for t in tabs if len(plc.replicas[t]) == 1]
        if tenants:
            groups: dict[str, list[int]] = {}
            for t in solo:
                groups.setdefault(owner_of(t).name, []).append(t)
            for name, ids in groups.items():
                add(s, ids, None, tenants[name])
        elif solo:
            add(s, solo, None)
    for t in plc.replicated_tables:
        owners = plc.replicas[t]
        for k, s in enumerate(owners):
            add(s, [t], (k, len(owners)), owner_of(t))
    return units, by_worker


@register("pool")
class PoolStorage(EmbeddingStorage):
    """Process-pool sharded tiered storage: N worker processes over one
    shared host cold tier, one merged report."""

    def __init__(self, ebc):
        super().__init__(ebc)
        _reject_double_remap(self.cfg, "pool")
        self.placement: Optional[ShardPlacement] = None
        self.migration_threshold: Optional[float] = None
        self._transports: list = []
        self._units: list[_RemoteUnit] = []
        self._worker_units: list[list[_RemoteUnit]] = []
        self._routers: dict[int, ReplicaRouter] = {}
        self._valid_hint: Optional[int] = None
        self._rpc_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._closed = False
        self._epoch = 0
        self._segment = None                  # shared cold-table segment
        self._seg_meta: Optional[tuple] = None    # (name, dtype str, shape)
        self._tables: Optional[np.ndarray] = None  # the collection's copy
        self._dtype = None
        self._ps_cfg = None
        self._hot_plans: Optional[dict] = None    # table -> HotPlan
        self._replicate_factor = 0.0
        self._degraded = False
        self._prefetch_depth = 0
        self._depth_override: Optional[int] = None
        self._tenants: dict[str, TenantNamespace] = {}
        self._tenant_hints: dict[str, int] = {}
        self._tenant_degraded: dict[str, bool] = {}
        self._tenant_depth: dict[str, int] = {}   # respawn re-applies
        self._version = 0
        self._update_txn = None
        self._tenant_versions: dict[str, int] = {}
        self._tenant_txns: dict[str, Any] = {}
        self._timeout = DEFAULT_TIMEOUT
        self._threads: Optional[int] = None   # intra-op threads a worker
        self._ctx = None
        # backend-level sliding traffic window — migration plans from FULL
        # batches, exactly as in ShardedStorage
        self.window: deque = deque(maxlen=16)

    # -- descriptor ---------------------------------------------------------
    def capabilities(self) -> StorageCapabilities:
        # derived pool-side without an RPC: worker prefetch depth only
        # moves through set_prefetch_depth (tracked), and fused support is
        # a pure function of the shared PSConfig
        live = bool(self._units) and not self._closed
        stageable = live and self._prefetch_depth > 0
        return StorageCapabilities(
            device_resident=False,
            stageable=stageable,
            async_prefetch=stageable and self._ps_cfg.async_prefetch,
            refreshable=True,
            shardable=True,
            tunable=live,
            migratable=live,
            degradable=live,
            fused_lookup=live and self._ps_cfg.fused_lookup,
            updatable=live)

    @property
    def num_shards(self) -> int:
        return 0 if self.placement is None else self.placement.num_shards

    @property
    def num_workers(self) -> int:
        return len(self._transports)

    # -- construction -------------------------------------------------------
    def _plan_hot(self, ps_cfg, trace: Optional[np.ndarray]
                  ) -> Optional[dict]:
        """Per-table hot plans, computed ONCE pool-side — identical to the
        plans each trace-fed ParameterServer would derive for its slice
        (`plan_from_trace(trace[:, t])` is per-table), and reusable
        verbatim when a crashed worker respawns."""
        k = min(ps_cfg.hot_rows, self.cfg.rows)
        if trace is None or k <= 0:
            return None
        from repro_torch.core import hot_cache
        return {t: hot_cache.plan_from_trace(trace[:, t], self.cfg.rows, k)
                for t in range(self.cfg.num_tables)}

    def _construct_payload(self, units: list[_RemoteUnit],
                           plans: Optional[dict]) -> dict:
        """The `construct`/`construct_pending` payload of one worker: its
        unit specs on the collection's device, the shared `PSConfig`, and
        the hot plans of its own tables."""
        device = str(self.ebc.device)
        tables = sorted({int(t) for u in units for t in u.table_ids})
        return {"units": [u.spec(device) for u in units],
                "ps_cfg": self._ps_cfg,
                "plans_by_table": _wire_plans(plans, tables)}

    @staticmethod
    def _fill_segment(tables: np.ndarray) -> tuple:
        """A new shared-memory segment holding `tables`, and its
        (name, dtype str, shape)."""
        seg = create_segment(tables.nbytes)
        np.ndarray(tables.shape, tables.dtype, buffer=seg.buf)[...] = tables
        return seg, (seg.name, tables.dtype.str, tables.shape)

    def _boot(self, t, units: list[_RemoteUnit], seg_meta: tuple) -> None:
        """Attach a fresh worker to the shared segment (with its share of
        the host's cores) and construct its units in the published
        serving mode."""
        name, dtype, shape = seg_meta
        t.call("attach_tables",
               {"name": name, "dtype": dtype, "shape": shape,
                "threads": self._threads},
               timeout=self._timeout)
        t.call("construct",
               {**self._construct_payload(units, self._hot_plans),
                "degraded": self._degraded,
                "prefetch_depth": self._depth_override},
               timeout=self._timeout)

    def _spawn_and_construct(self, num_workers: int,
                             by_worker: list[list[_RemoteUnit]],
                             seg_meta: tuple) -> list:
        """Spawn `num_workers` processes and construct their units; on ANY
        failure every new process is destroyed and the (new) segment is
        left for the caller to reclaim — live state is never touched."""
        if self._ctx is None:
            self._ctx = multiprocessing.get_context("spawn")
        transports = [spawn_worker(w, self._ctx)
                      for w in range(num_workers)]

        def boot(w: int) -> None:
            self._boot(transports[w], by_worker[w], seg_meta)

        try:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=num_workers) as ex:
                list(ex.map(boot, range(num_workers)))
        except BaseException:
            for t in transports:
                t.destroy()
            raise
        return transports

    def build(self, ps_cfg=None, trace: Optional[np.ndarray] = None, *,
              num_workers: int = 2,
              num_shards: Optional[int] = None,
              placement: Union[str, ShardPlacement, None] = None,
              device_budget_bytes: Optional[int] = None,
              migration_threshold: Optional[float] = None,
              replicate_factor: float = 0.0,
              tenants: Optional[dict] = None,
              rpc_timeout: float = DEFAULT_TIMEOUT,
              **ps_cfg_overrides) -> "PoolStorage":
        """Spawn the worker pool and install the placement's units on it.

        `num_shards` defaults to `num_workers` (one shard per process);
        `placement`/`migration_threshold`/`replicate_factor` carry the
        exact `ShardedStorage.build` semantics. The cold tables are copied
        ONCE into a host shared-memory segment; workers map it read-only.

        Rebuild-safe across processes: on a live backend the new workers
        are spawned and fully constructed BEFORE the old pool tears down,
        so a spawn or constructor failure leaves the old workers serving.

        `tenants` ({name: table_count}) turns on multi-tenant mode with
        the `ShardedStorage` semantics (tenant-pure units, `tenant_*`
        verbs, tenant-shaped stats, migration disabled). Pool tenancy is
        STATIC — `attach_tenant` mid-serving would have to re-carve the
        shared host segment; rebuild with the full tenant set instead.

        The segment is filled from the collection's host `tables`; the
        workers' parameter servers live on the collection's device.
        """
        cfg = self.cfg
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if num_shards is None:
            num_shards = num_workers
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        num_shards = min(num_shards, cfg.num_tables)
        trace = _as_numpy(trace)
        ps_cfg = build_ps_config(trace, cfg.rows, cfg.dim,
                                 cfg.torch_dtype.itemsize, ps_cfg,
                                 device_budget_bytes, **ps_cfg_overrides)
        # the host tensor's bytes (the authoritative copy), not a copy
        tables = np.ascontiguousarray(
            host_array(self.ebc.tables[:cfg.num_tables])[0])
        spaces = (resolve_tenants(tenants, cfg.num_tables)
                  if tenants else {})
        if spaces and migration_threshold is not None:
            raise ValueError("migration is disabled under tenancy (the "
                             "arbiter re-splits capacity instead) — drop "
                             "migration_threshold or tenants")
        plc = resolve_placement(cfg, placement, num_shards, trace)
        num_workers = min(num_workers, plc.num_shards)

        # everything that can raise runs BEFORE the old pool is touched
        old_ps_cfg, old_plans = self._ps_cfg, self._hot_plans
        old_degraded, old_depth = self._degraded, self._depth_override
        old_timeout, old_threads = self._timeout, self._threads
        self._ps_cfg = ps_cfg
        self._timeout = float(rpc_timeout)
        self._threads = max(1, len(os.sched_getaffinity(0)) // num_workers)
        self._hot_plans = self._plan_hot(ps_cfg, trace)
        self._degraded = False        # a full (re)build starts exact
        self._depth_override = None
        seg, seg_meta = self._fill_segment(tables)
        units, by_worker = _plan_units(plc, num_workers,
                                       tenants=spaces or None)
        try:
            transports = self._spawn_and_construct(num_workers, by_worker,
                                                   seg_meta)
        except BaseException:
            seg.close()
            seg.unlink()
            self._ps_cfg, self._hot_plans = old_ps_cfg, old_plans
            self._degraded, self._depth_override = old_degraded, old_depth
            self._timeout, self._threads = old_timeout, old_threads
            raise

        # swap: new pool serves, then the old one tears down
        old_transports, old_seg = self._transports, self._segment
        old_rpc_pool = self._rpc_pool
        self._transports = transports
        self._segment, self._seg_meta = seg, seg_meta
        self._tables, self._dtype = tables, tables.dtype
        self._install(plc, units)
        self._tenants = spaces
        self._tenant_hints = {}
        self._tenant_degraded = {name: False for name in spaces}
        self._tenant_depth = {}
        self.migration_threshold = migration_threshold
        self._replicate_factor = float(replicate_factor)
        self._prefetch_depth = ps_cfg.prefetch_depth
        # a (re)build installs fresh tables: version history restarts
        self._version = 0
        self._update_txn = None
        self._tenant_versions = {name: 0 for name in spaces}
        self._tenant_txns = {}
        self.window = deque(maxlen=ps_cfg.window_batches)
        self._valid_hint = None
        self._closed = False
        self._rpc_pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="pool-rpc")
            if num_workers > 1 else None)
        for t in old_transports:
            t.shutdown()
        if old_rpc_pool is not None:
            old_rpc_pool.shutdown(wait=True)
        if old_seg is not None:
            old_seg.close()
            old_seg.unlink()
        return self

    def _install(self, plc: ShardPlacement,
                 units: list[_RemoteUnit]) -> None:
        """Pool-side half of the swap (workers already serve `units`):
        placement, routing, epoch. All-or-nothing — router construction
        runs before the first assignment."""
        routers = {t: ReplicaRouter(len(plc.replicas[t]))
                   for t in plc.replicated_tables}
        self.placement = plc
        self._units = units
        by_worker: list[list[_RemoteUnit]] = \
            [[] for _ in range(len(self._transports))]
        for u in units:
            by_worker[u.worker].append(u)
        self._worker_units = by_worker
        self._routers = routers
        self._epoch += 1

    def _require_built(self) -> None:
        if self._closed:
            raise RuntimeError(
                "storage='pool' backend is closed (its worker processes "
                "are joined) — build() it again before serving")
        if not self._units:
            raise RuntimeError(
                "storage='pool' needs its worker pool: call "
                "ebc.storage.build(ps_cfg, num_workers=N) first")

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

    def _tenant_units(self, name: str) -> list[_RemoteUnit]:
        self._ns(name)
        return [u for u in self._units if u.tenant == name]

    def _tenant_worker_ids(self, name: str) -> dict[int, list[int]]:
        """worker -> this tenant's unit ids on it (only nonempty)."""
        out: dict[int, list[int]] = {}
        for u in self._tenant_units(name):
            out.setdefault(u.worker, []).append(u.unit_id)
        return out

    # -- worker fan-out & crash recovery ------------------------------------
    def _map_workers(self, fn, workers: Optional[list[int]] = None
                     ) -> tuple[dict, dict]:
        """Apply fn(worker_index) across workers (RPC pool when one
        exists), collecting `WorkerDeadError`/`RemoteCallError` per worker
        instead of raising — the caller decides between retry-after-
        respawn (dead) and propagate (remote bug)."""
        targets = list(range(len(self._transports))) \
            if workers is None else workers
        outs: dict[int, Any] = {}
        errs: dict[int, Exception] = {}

        def guarded(w):
            try:
                return w, fn(w), None
            except (WorkerDeadError, RemoteCallError) as e:
                return w, None, e

        if self._rpc_pool is None:
            results = [guarded(w) for w in targets]
        else:
            results = list(self._rpc_pool.map(guarded, targets))
        for w, out, err in results:
            if err is None:
                outs[w] = out
            else:
                errs[w] = err
        return outs, errs

    def _call(self, w: int, verb: str, payload: dict | None = None):
        return self._transports[w].call(verb, payload,
                                        timeout=self._timeout)

    def _respawn_worker(self, w: int) -> None:
        """Replace a dead worker process with a fresh one serving the SAME
        units, rebuilt from the shared host tier with the build-time hot
        plans. Caches restart cold and per-worker counters restart at
        zero; served values never change (every tier re-copies the same
        authoritative bytes)."""
        self._transports[w].destroy()
        if self._ctx is None:
            self._ctx = multiprocessing.get_context("spawn")
        t = spawn_worker(w, self._ctx)
        try:
            self._boot(t, self._worker_units[w], self._seg_meta)
        except BaseException:
            t.destroy()
            raise
        self._transports[w] = t
        # per-tenant mode/depth are pool-side state the fresh worker does
        # not know — re-apply them to its slice of each tenant's units
        for name, on in self._tenant_degraded.items():
            if on:
                ids = [u.unit_id for u in self._worker_units[w]
                       if u.tenant == name]
                if ids:
                    t.call("set_degraded", {"on": True, "unit_ids": ids},
                           timeout=self._timeout)
        for name, depth in self._tenant_depth.items():
            ids = [u.unit_id for u in self._worker_units[w]
                   if u.tenant == name]
            if ids:
                t.call("set_prefetch_depth",
                       {"depth": int(depth), "unit_ids": ids},
                       timeout=self._timeout)

    def _recover(self, errs: dict) -> None:
        """Respawn every worker that died; re-raise the first non-crash
        (remote bug) error — those must surface, not retry."""
        remote = [e for e in errs.values()
                  if not isinstance(e, WorkerDeadError)]
        if remote:
            raise remote[0]
        for w in errs:
            self._respawn_worker(w)

    def _fan_out_retry(self, fn, what: str) -> dict:
        """Run fn across all workers; dead workers are respawned and ONLY
        their slice re-runs (survivors' results are kept). A second
        consecutive death on the same slice propagates."""
        outs, errs = self._map_workers(fn)
        if errs:
            self._recover(errs)
            outs2, errs2 = self._map_workers(fn, list(errs))
            if errs2:
                raise next(iter(errs2.values()))
            outs.update(outs2)
        return outs

    # -- data path ----------------------------------------------------------
    def _unit_bounds(self, u: _RemoteUnit, batch: int) -> tuple[int, int]:
        """Identical law to `ShardedStorage._unit_bounds`: full batch for
        solo units, the router's cut (or the equal `np.array_split` law)
        for replica units."""
        if u.chunk is None:
            return 0, batch
        k, r = u.chunk
        router = self._routers.get(int(u.table_ids[0]))
        if router is not None:
            b = router.bounds(batch)
            return int(b[k]), int(b[k + 1])
        return _chunk_bounds(batch, r, k)

    def _lookup_work(self, w: int, idx: np.ndarray, w_np, valid,
                     fused: bool, only: Optional[set] = None
                     ) -> tuple[list, list]:
        """Cut worker `w`'s per-unit request items + scatter metadata.
        `u.cols` maps each unit's tables onto the caller-batch columns
        (global ids normally, namespace-local under tenancy); `only`
        restricts to a tenant's unit ids."""
        B = idx.shape[0]
        work, meta = [], []
        for u in self._worker_units[w]:
            if only is not None and u.unit_id not in only:
                continue
            lo, hi = self._unit_bounds(u, B)
            if lo == hi:
                continue
            item = {"unit_id": u.unit_id,
                    "idx": idx[lo:hi][:, u.cols]}
            if valid is not None:
                item["valid"] = int(np.clip(valid - lo, 0, hi - lo))
            if fused and w_np is not None:
                item["weights"] = w_np[lo:hi][:, u.cols]
            work.append(item)
            meta.append((u, lo, hi))
        return work, meta

    def _fan_lookup(self, idx: np.ndarray, weights, valid: Optional[int],
                    T: int, only: Optional[set] = None) -> torch.Tensor:
        """Fan a [B, T, L] lookup out across worker processes, join,
        scatter the per-unit blocks, pool — bit-identical to the sharded
        (and single-server tiered) path: same bounds law, same scatter,
        same pooling. A worker that dies mid-batch is respawned from the
        shared tier and only ITS slice re-runs. `only` restricts the
        fan-out to a tenant's unit ids."""
        B, _, L = idx.shape
        dim = self.cfg.dim
        device = self.ebc.device
        dtype = self.cfg.torch_dtype
        fused_path = self._ps_cfg.fused_lookup
        w_np = _as_numpy(weights)

        def run_worker(w: int):
            work, meta = self._lookup_work(w, idx, w_np, valid, fused_path,
                                           only=only)
            if not work:
                return []
            res = self._call(w, "lookup", {"work": work, "fused": fused_path,
                                           "combine": self.cfg.combine})
            return list(zip(meta, res["results"]))

        outs = self._fan_out_retry(run_worker, "lookup")
        results = [(u, lo, hi, r) for res in outs.values()
                   for (u, lo, hi), r in res]
        for u, _, _, r in results:
            u.service_s += r["service_s"]
            u.served_rows += r["served"]

        if fused_path:
            # each unit's pooled [b, t, D] block lands at rows lo:hi and
            # columns cols of one output on the device (sharded's fan-in)
            pooled_out = torch.empty((B, T, dim), device=device, dtype=dtype)
            for u, lo, hi, r in results:
                pooled_out[lo:hi].index_copy_(
                    1, torch.from_numpy(u.cols).to(device),
                    to_tensor(r["block"], dtype).to(device))
            return pooled_out

        out = np.empty((B, T, L, dim), self._dtype)
        for u, lo, hi, r in results:
            out[lo:hi, u.cols] = r["block"]
        # pooled once on the device, each bag as the device backend pools
        # it (the tiered and sharded backends' per-row path)
        w = None if w_np is None else np.asarray(
            w_np, np.float32).reshape(B * T, L)
        pooled = fused.pool_bag_rows(
            to_tensor(out, dtype).reshape(B * T, L, dim), w,
            mode=self.cfg.combine, device=device)
        return pooled.view(B, T, dim)

    def lookup(self, indices, weights=None, *,
               pre_remapped: bool = False) -> torch.Tensor:
        """Whole-backend [B, T, L] lookup; undefined under tenancy —
        serve through the per-tenant views instead."""
        self._require_built()
        self._reject_under_tenancy("lookup")
        idx = _as_numpy(indices)
        valid, self._valid_hint = self._valid_hint, None
        real = idx if valid is None else idx[:valid]
        if real.shape[0]:
            self.window.append(real)
        return self._fan_lookup(idx, weights, valid, idx.shape[1])

    # -- prefetch -----------------------------------------------------------
    def can_stage(self) -> bool:
        """All-units backpressure, asked of every worker (a staged batch
        is resident on all units or on none). A dead worker answers False
        this round; it is respawned before the next."""
        if not self._units or self._closed:
            return False
        outs, errs = self._map_workers(
            lambda w: self._call(w, "can_stage")["ok"])
        if errs:
            self._recover(errs)
            return False
        return all(outs.values())

    def _fan_stage(self, idx: np.ndarray,
                   only: Optional[set] = None) -> bool:
        def run_worker(w: int) -> bool:
            work, _ = self._lookup_work(w, idx, None, None, False,
                                        only=only)
            if not work:
                return True
            return self._call(w, "stage", {"work": work})["ok"]

        outs, errs = self._map_workers(run_worker)
        if errs:
            # staging is correctness-neutral: recover and report failure
            self._recover(errs)
            return False
        return all(outs.values())

    def stage(self, next_indices: np.ndarray) -> bool:
        self._require_built()
        self._reject_under_tenancy("stage")
        return self._fan_stage(_as_numpy(next_indices))

    def hint_valid(self, n: int) -> None:
        self._valid_hint = int(n)

    # -- degraded (warm-cache-only) overload mode ----------------------------
    def degraded(self) -> bool:
        return self._degraded

    def set_degraded(self, on: bool) -> bool:
        """Lockstep across every worker; the pool-level flag survives
        migration swaps AND worker respawns (both re-apply it)."""
        if not self._units:
            return False
        self._degraded = bool(on)
        self._fan_out_retry(
            lambda w: self._call(w, "set_degraded", {"on": bool(on)}),
            "set_degraded")
        for name in self._tenant_degraded:   # keep per-tenant flags honest
            self._tenant_degraded[name] = bool(on)
        return True

    # -- refresh ------------------------------------------------------------
    def refresh_window(self) -> dict:
        """Pool-side snapshot: the full-batch traffic window (migration
        re-planning) and the epoch guard. Per-unit windows stay inside
        the workers — hot-set re-planning runs worker-side."""
        return {"traffic": list(self.window), "epoch": self._epoch}

    def plan_refresh(self, window=None):
        """Hot-set plans come from each worker's live per-unit windows
        (the window never crosses the pipe); placement re-planning runs
        pool-side from the full-batch window, as in ShardedStorage.
        Helper-thread safe: worker RPCs serialize against serving calls
        on the per-transport lock."""
        self._require_built()
        if window is None:
            window = self.refresh_window()
        unit_plans = None
        if window["epoch"] == self._epoch:
            outs = self._fan_out_retry(
                lambda w: self._call(w, "plan_refresh")["plans"],
                "plan_refresh")
            merged = {}
            for plans in outs.values():
                merged.update(plans)
            if any(p is not None for p in merged.values()):
                unit_plans = merged
        migration = None
        if self.migration_threshold is not None:
            migration = self.plan_migration(window)
        if unit_plans is None and migration is None:
            return None
        return {"units": unit_plans, "migration": migration,
                "epoch": window["epoch"]}

    def install_refresh(self, plan) -> dict:
        self._require_built()
        if plan is not None and plan.get("migration") is not None:
            result = self.install_migration(plan["migration"])
            result["replanned"] = result.get("migrated", False)
            result.setdefault("refreshes", 0)
            return result
        if plan is not None and (
                plan["epoch"] != self._epoch or plan["units"] is None):
            # planned against units that no longer exist: drop it
            plan = None
        unit_plans = {} if plan is None else plan["units"]

        def run_worker(w: int) -> dict:
            mine = {u.unit_id: unit_plans.get(u.unit_id)
                    for u in self._worker_units[w]}
            return self._call(w, "install_refresh", {"plans": mine})

        outs = self._fan_out_retry(run_worker, "install_refresh")
        return {"replanned": any(r["replanned"] for r in outs.values()),
                "refreshes": max((r["refreshes"] for r in outs.values()),
                                 default=0)}

    def refresh(self) -> dict:
        return self.install_refresh(self.plan_refresh())

    # -- live migration & routing -------------------------------------------
    def update_routing(self) -> Optional[dict]:
        """Identical to the sharded law — the per-replica service costs
        were timed INSIDE the workers, so RPC overhead never pollutes the
        routing signal. A table whose published split moved gets its
        replica units' staged batches flushed worker-side."""
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
        if changed_tables:
            stale: dict[int, list[int]] = {}
            for u in self._units:
                if u.chunk is not None and \
                        int(u.table_ids[0]) in changed_tables:
                    stale.setdefault(u.worker, []).append(u.unit_id)
            outs, errs = self._map_workers(
                lambda w: self._call(w, "flush_prefetch",
                                     {"unit_ids": stale[w]}),
                list(stale))
            if errs:
                self._recover(errs)
        return {"changed": bool(changed_tables), "fractions": fractions}

    def plan_migration(self, window: Any = None, *,
                       threshold: Optional[float] = None
                       ) -> Optional[dict]:
        """Pure pool-side re-planning from the full-batch window — the
        verbatim ShardedStorage law (thresholded imbalance, material-gain
        gate, hot plans from the same window)."""
        self._require_built()
        if self._tenants:
            # under tenancy fairness is the arbiter's job — see sharded
            return None
        if window is None:
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
        """Apply a migration plan build-before-teardown ACROSS PROCESSES:

        phase 1 constructs the new units as pending on every worker (the
        old units keep serving); any failure — a constructor error or a
        worker killed mid-swap — aborts the survivors' pending units and
        respawns the dead workers with the CURRENT units, so the old pool
        is still serving, bit-exactly. Only when every worker holds its
        pending units does phase 2 commit them everywhere (worker-local
        swap, old units closed after); a death during commit rolls
        FORWARD — the respawn rebuilds the new placement."""
        self._require_built()
        if plan is None:
            return {"migrated": False}
        mig: MigrationPlan = plan["migration"]
        if mig.old.replicas != self.placement.replicas or \
                mig.old.num_shards != self.placement.num_shards:
            return {"migrated": False, "stale_plan": True}
        hot_plans = plan.get("hot_plans")
        units, by_worker = _plan_units(mig.new, len(self._transports))

        # phase 1: construct pending everywhere, serving untouched
        def construct(w: int):
            return self._call(w, "construct_pending",
                              self._construct_payload(by_worker[w],
                                                      hot_plans))

        outs, errs = self._map_workers(construct)
        if errs:
            dead = [w for w, e in errs.items()
                    if isinstance(e, WorkerDeadError)]
            live = [w for w in range(len(self._transports))
                    if w not in dead]
            self._map_workers(
                lambda w: self._call(w, "abort_pending"), live)
            for w in dead:
                self._respawn_worker(w)       # rebuilds the CURRENT units
            remote = [e for e in errs.values()
                      if not isinstance(e, WorkerDeadError)]
            if remote:
                raise remote[0]
            return {"migrated": False, "rolled_back": True,
                    "respawned_workers": dead}

        # phase 2: commit everywhere; the swap is now declared, so a death
        # here rolls forward (the respawn constructs the NEW units)
        self._install(mig.new, units)
        self._hot_plans = hot_plans if hot_plans is not None \
            else self._hot_plans
        outs, errs = self._map_workers(
            lambda w: self._call(w, "commit_pending",
                                 {"prefetch_depth": self._depth_override}))
        if errs:
            self._recover(errs)
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
        cfg = self.cfg
        require_open(self._update_txn, "apply_update").add(
            table, rows, values, num_tables=cfg.num_tables,
            num_rows=cfg.rows, dim=cfg.dim, dtype=self._dtype)
        return True

    def _segment_tables(self) -> np.ndarray:
        """Writable [T, R, D] view over the shared cold-table segment —
        the pool is the segment OWNER (workers map it read-only)."""
        _, dtype, shape = self._seg_meta
        return np.ndarray(tuple(shape), np.dtype(dtype),
                          buffer=self._segment.buf)

    def _distribute_commit(self, version: int, merged: dict) -> dict:
        """Two-phase distributed commit of `merged` ({global table ->
        (rows, values)}) across the worker pool.

        Phase 1 ships the rows to every worker hosting a touched table,
        which BUFFERS them (no tier touched). A worker killed here — the
        'between apply and commit' crash the rollback test drives — aborts
        the survivors' buffers and respawns the dead worker against the
        UNMODIFIED segment: the old version keeps serving bit-exactly.

        Only when every worker holds its buffer does phase 2 write the new
        bytes into the shared segment (no lookup is in flight during this
        synchronous call, so the write races nothing) and commit the
        caches everywhere. A death in phase 2 rolls FORWARD: the respawn
        rebuilds every tier from the already-updated segment."""
        tables_by_worker: dict[int, dict] = {}
        for w, units in enumerate(self._worker_units):
            owned = {int(t) for u in units for t in u.table_ids}
            mine = {t: payload for t, payload in merged.items()
                    if t in owned}
            if mine:
                tables_by_worker[w] = mine
        targets = sorted(tables_by_worker)

        outs, errs = self._map_workers(
            lambda w: self._call(w, "apply_update",
                                 {"version": int(version),
                                  "tables": tables_by_worker[w]}),
            targets)
        if errs:
            dead = [w for w, e in errs.items()
                    if isinstance(e, WorkerDeadError)]
            live = [w for w in targets if w not in dead]
            self._map_workers(
                lambda w: self._call(w, "abort_update"), live)
            for w in dead:
                self._respawn_worker(w)   # old segment bytes: old version
            remote = [e for e in errs.values()
                      if not isinstance(e, WorkerDeadError)]
            if remote:
                raise remote[0]
            return {"updated": False, "rolled_back": True,
                    "respawned_workers": dead}

        seg = self._segment_tables()
        applied = 0
        for t, (rows, vals) in merged.items():
            seg[t, rows] = vals
            # the collection's copy too: a rebuild reads it
            self._tables[t, rows] = vals
            applied += int(rows.size)

        outs, errs = self._map_workers(
            lambda w: self._call(w, "commit_update",
                                 {"version": int(version)}),
            targets)
        respawned: list[int] = []
        if errs:
            respawned = sorted(errs)
            self._recover(errs)   # roll forward — see the docstring
        return {"updated": True, "rows": applied, "tables": len(merged),
                "respawned_workers": respawned}

    def commit_update(self, version: int) -> dict:
        from repro_torch.core.update import require_open
        self._require_built()
        self._reject_under_tenancy("commit_update")
        txn = require_open(self._update_txn, "commit_update")
        txn.check_commit(version)
        res = self._distribute_commit(version, txn.merged())
        self._update_txn = None   # a rollback drops the buffered rows too
        if res.get("updated"):
            self._version = txn.version
            res["version"] = self._version
        return res

    def abort_update(self, version: int) -> bool:
        if self._update_txn is None:
            return False
        self._update_txn.check_commit(version)
        self._update_txn = None
        return True

    def tenant_version(self, name: str) -> int:
        self._ns(name)
        return self._tenant_versions.get(name, 0)

    def tenant_begin_update(self, name: str, version: int) -> bool:
        from repro_torch.core.update import UpdateTxn
        self._require_built()
        self._ns(name)
        open_txn = self._tenant_txns.get(name)
        if open_txn is not None:
            raise RuntimeError(
                f"tenant {name!r} already has an update to "
                f"v{open_txn.version} open — commit or abort it first")
        self._tenant_txns[name] = UpdateTxn(
            version, self._tenant_versions.get(name, 0))
        return True

    def tenant_apply_update(self, name: str, table: int, rows,
                            values) -> bool:
        from repro_torch.core.update import require_open
        ns = self._ns(name)
        require_open(self._tenant_txns.get(name), "apply_update").add(
            table, rows, values, num_tables=ns.num_tables,
            num_rows=self.cfg.rows, dim=self.cfg.dim, dtype=self._dtype)
        return True

    def tenant_commit_update(self, name: str, version: int) -> dict:
        """Tenant-scoped two-phase commit: table ids translate from the
        namespace to the global axis, and tenant-pure units mean the
        fan-out only ever touches THIS tenant's units — a sibling's
        version and caches are untouched by construction."""
        from repro_torch.core.update import require_open
        self._require_built()
        ns = self._ns(name)
        txn = require_open(self._tenant_txns.get(name), "commit_update")
        txn.check_commit(version)
        merged = {ns.start + t: payload
                  for t, payload in txn.merged().items()}
        res = self._distribute_commit(version, merged)
        self._tenant_txns.pop(name, None)
        if res.get("updated"):
            self._tenant_versions[name] = txn.version
            res["version"] = txn.version
            res["tenant"] = name
        return res

    def tenant_abort_update(self, name: str, version: int) -> bool:
        txn = self._tenant_txns.get(name)
        if txn is None:
            return False
        txn.check_commit(version)
        self._tenant_txns.pop(name, None)
        return True

    # -- runtime tuning ------------------------------------------------------
    def prefetch_depth(self) -> int:
        return self._prefetch_depth if self._units else 0

    def set_prefetch_depth(self, depth: int) -> bool:
        if not self._units:
            return False
        self._depth_override = int(depth)
        outs = self._fan_out_retry(
            lambda w: self._call(w, "set_prefetch_depth",
                                 {"depth": int(depth)})["depth"],
            "set_prefetch_depth")
        self._prefetch_depth = max(outs.values(), default=0)
        return True

    def take_prefetch_window_peak(self) -> int:
        if not self._units or self._closed:
            return 0
        outs = self._fan_out_retry(
            lambda w: self._call(w, "take_window_peak")["peak"],
            "take_window_peak")
        return max(outs.values(), default=0)

    def retune_capacities(self, budget_bytes: int) -> Optional[dict]:
        """Budget split by table count pool-side (same law as sharded);
        each worker retunes its own units from their live windows."""
        self._require_built()
        total_tables = sum(len(u.table_ids) for u in self._units)

        def run_worker(w: int) -> dict:
            shares = {u.unit_id: int(budget_bytes * len(u.table_ids)
                                     / total_tables)
                      for u in self._worker_units[w]}
            if not shares:
                return {}
            return self._call(w, "retune", {"shares": shares})["results"]

        outs = self._fan_out_retry(run_worker, "retune")
        done = [r for res in outs.values() for r in res.values()
                if r is not None]
        if not done:
            return None
        return {"retuned_units": len(done),
                "hot_rows": max(r["hot_rows"] for r in done),
                "warm_slots": max(r["warm_slots"] for r in done),
                "budget_bytes": int(budget_bytes)}

    def device_bytes(self) -> int:
        """Total device-resident cache bytes across every worker's units
        (hot blocks + warm payloads; the shared host cold tier does not
        count)."""
        if not self._units or self._closed:
            return 0
        outs = self._fan_out_retry(lambda w: self._call(w, "stats"),
                                   "stats")
        return sum(e["device_bytes"] for res in outs.values()
                   for e in res["units"].values())

    # -- tenancy ------------------------------------------------------------
    @property
    def tenants(self) -> dict:
        """Attached tenant namespaces, {name: TenantNamespace} (copy)."""
        return dict(self._tenants)

    def tenant_lookup(self, name: str, indices, weights=None):
        """One tenant's [B, T_tenant, L] lookup over its own units — the
        same fan-out/scatter/pool as `lookup()` restricted to tenant-pure
        units with namespace-local columns; pooling divides by THIS
        batch's L."""
        self._require_built()
        only = {u.unit_id for u in self._tenant_units(name)}
        idx = _as_numpy(indices)
        valid = self._tenant_hints.pop(name, None)
        return self._fan_lookup(idx, weights, valid, idx.shape[1],
                                only=only)

    def tenant_stage(self, name: str, next_indices) -> bool:
        self._require_built()
        only = {u.unit_id for u in self._tenant_units(name)}
        return self._fan_stage(_as_numpy(next_indices), only=only)

    def tenant_can_stage(self, name: str) -> bool:
        if not self._units or self._closed:
            return False
        by_w = self._tenant_worker_ids(name)
        if not by_w:
            return False
        outs, errs = self._map_workers(
            lambda w: self._call(w, "can_stage",
                                 {"unit_ids": by_w[w]})["ok"],
            list(by_w))
        if errs:
            self._recover(errs)
            return False
        return all(outs.values())

    def tenant_hint_valid(self, name: str, n: int) -> None:
        self._ns(name)
        self._tenant_hints[name] = int(n)

    def tenant_refresh_window(self, name: str) -> dict:
        # per-unit windows live inside the workers (as for the whole-pool
        # refresh); the snapshot is just the epoch guard
        self._ns(name)
        return {"epoch": self._epoch}

    def tenant_plan_refresh(self, name: str, window=None):
        self._require_built()
        if window is None:
            window = self.tenant_refresh_window(name)
        if window["epoch"] != self._epoch:
            return None
        by_w = self._tenant_worker_ids(name)

        def run_worker(w: int) -> dict:
            if w not in by_w:
                return {}
            return self._call(w, "plan_refresh",
                              {"unit_ids": by_w[w]})["plans"]

        outs = self._fan_out_retry(run_worker, "plan_refresh")
        merged = {}
        for plans in outs.values():
            merged.update(plans)
        if not any(p is not None for p in merged.values()):
            return None
        return {"units": merged, "epoch": window["epoch"]}

    def tenant_install_refresh(self, name: str, plan) -> dict:
        self._require_built()
        by_w = self._tenant_worker_ids(name)
        stale = (plan is None or plan["epoch"] != self._epoch
                 or plan["units"] is None)
        unit_plans = {} if stale else plan["units"]

        def run_worker(w: int) -> dict:
            if w not in by_w:
                return {"replanned": False, "refreshes": 0}
            mine = {uid: unit_plans.get(uid) for uid in by_w[w]}
            return self._call(w, "install_refresh",
                              {"plans": mine, "unit_ids": by_w[w]})

        outs = self._fan_out_retry(run_worker, "install_refresh")
        return {"replanned": any(r["replanned"] for r in outs.values()),
                "refreshes": max((r["refreshes"] for r in outs.values()),
                                 default=0)}

    def tenant_prefetch_depth(self, name: str) -> int:
        by_w = self._tenant_worker_ids(name)

        def run_worker(w: int) -> int:
            if w not in by_w:
                return 0
            return self._call(w, "prefetch_depth",
                              {"unit_ids": by_w[w]})["depth"]

        outs = self._fan_out_retry(run_worker, "prefetch_depth")
        return max(outs.values(), default=0)

    def tenant_set_prefetch_depth(self, name: str, depth: int) -> bool:
        by_w = self._tenant_worker_ids(name)
        if not by_w:
            return False
        self._tenant_depth[name] = int(depth)   # respawn re-applies

        def run_worker(w: int):
            if w not in by_w:
                return None
            return self._call(w, "set_prefetch_depth",
                              {"depth": int(depth),
                               "unit_ids": by_w[w]})

        self._fan_out_retry(run_worker, "set_prefetch_depth")
        return True

    def tenant_take_prefetch_window_peak(self, name: str) -> int:
        by_w = self._tenant_worker_ids(name)

        def run_worker(w: int) -> int:
            if w not in by_w:
                return 0
            return self._call(w, "take_window_peak",
                              {"unit_ids": by_w[w]})["peak"]

        outs = self._fan_out_retry(run_worker, "take_window_peak")
        return max(outs.values(), default=0)

    def tenant_retune_capacities(self, name: str,
                                 budget_bytes: int) -> Optional[dict]:
        """Re-split one tenant's slice of the shared budget across its
        units (by table count — the whole-backend law scoped down)."""
        self._require_built()
        units = self._tenant_units(name)
        total_tables = sum(len(u.table_ids) for u in units)
        if not total_tables:
            return None
        share_of = {u.unit_id: int(budget_bytes * len(u.table_ids)
                                   / total_tables) for u in units}
        by_w = self._tenant_worker_ids(name)

        def run_worker(w: int) -> dict:
            if w not in by_w:
                return {}
            shares = {uid: share_of[uid] for uid in by_w[w]}
            return self._call(w, "retune", {"shares": shares})["results"]

        outs = self._fan_out_retry(run_worker, "retune")
        done = [r for res in outs.values() for r in res.values()
                if r is not None]
        if not done:
            return None
        return {"tenant": name,
                "retuned_units": len(done),
                "hot_rows": max(r["hot_rows"] for r in done),
                "warm_slots": max(r["warm_slots"] for r in done),
                "budget_bytes": int(budget_bytes)}

    def tenant_device_bytes(self, name: str) -> int:
        by_w = self._tenant_worker_ids(name)

        def run_worker(w: int):
            if w not in by_w:
                return {"units": {}}
            return self._call(w, "stats", {"unit_ids": by_w[w]})

        outs = self._fan_out_retry(run_worker, "stats")
        return sum(e["device_bytes"] for res in outs.values()
                   for e in res["units"].values())

    def tenant_degraded(self, name: str) -> bool:
        self._ns(name)
        return self._tenant_degraded.get(name, False)

    def tenant_set_degraded(self, name: str, on: bool) -> bool:
        by_w = self._tenant_worker_ids(name)
        if not by_w:
            return False
        self._tenant_degraded[name] = bool(on)   # respawn re-applies

        def run_worker(w: int):
            if w not in by_w:
                return None
            return self._call(w, "set_degraded",
                              {"on": bool(on), "unit_ids": by_w[w]})

        self._fan_out_retry(run_worker, "set_degraded")
        return True

    def _merge_tenant_entries(self, name: str, entries: list[dict]) -> dict:
        """Fold one tenant's per-unit worker stats entries (shard-grouped
        first, exactly like the whole-pool report) into its report."""
        by_shard: dict[int, list[dict]] = {}
        dev = 0
        for e in entries:
            by_shard.setdefault(e["shard"], []).append(e["stats"])
            dev += e["device_bytes"]
        per_shard = []
        for s in sorted(by_shard):
            group = by_shard[s]
            if len(group) == 1:
                per_shard.append(group[0])
            else:
                m = merge_shard_stats(group)
                m.pop("per_shard", None)
                m.pop("num_shards", None)
                per_shard.append(m)
        out = merge_shard_stats(per_shard)
        out["tenant"] = name
        out["device_bytes"] = int(dev)
        return out

    def tenant_stats(self, name: str) -> dict:
        self._require_built()
        by_w = self._tenant_worker_ids(name)

        def run_worker(w: int):
            if w not in by_w:
                return {"units": {}}
            return self._call(w, "stats", {"unit_ids": by_w[w]})

        outs = self._fan_out_retry(run_worker, "stats")
        entries = [e for res in outs.values()
                   for e in res["units"].values()]
        return self._merge_tenant_entries(name, entries)

    def tenant_reset_stats(self, name: str) -> None:
        by_w = self._tenant_worker_ids(name)

        def run_worker(w: int):
            if w not in by_w:
                return None
            return self._call(w, "reset_stats", {"unit_ids": by_w[w]})

        self._fan_out_retry(run_worker, "reset_stats")
        for u in self._tenant_units(name):
            u.service_s, u.served_rows = 0.0, 0

    def tenant_flush(self, name: str) -> None:
        by_w = self._tenant_worker_ids(name)

        def run_worker(w: int):
            if w not in by_w:
                return None
            return self._call(w, "flush", {"unit_ids": by_w[w]})

        self._fan_out_retry(run_worker, "flush")

    def attach_tenant(self, name: str, tables, *, trace=None):
        raise RuntimeError(
            "pool tenancy is static: admitting a tenant would have to "
            "re-carve the shared host segment across live worker "
            "processes — rebuild the pool with the full tenant set "
            "(build(..., tenants={...})), or serve elastic tenant sets "
            "from the 'sharded' backend, whose attach_tenant is live")

    def detach_tenant(self, name: str):
        raise RuntimeError(
            "pool tenancy is static: rebuild the pool with the reduced "
            "tenant set (build(..., tenants={...})), or serve elastic "
            "tenant sets from the 'sharded' backend")

    # -- stats & hygiene ----------------------------------------------------
    def worker_status(self) -> list[dict]:
        """Liveness heartbeat of every worker process — the operator (and
        `examples/serve_dlrm.py --storage pool`) summary line. A live
        worker's entry also carries the port-only fields of its `ping`:
        `launches` ({"bag", "fused"}: this process's kernel launches) and,
        once the worker has touched the card, `max_memory_allocated`."""
        out = []
        for w, t in enumerate(self._transports):
            entry = {"worker": w, "pid": t.pid, "alive": not t.dead}
            if not t.dead:
                try:
                    entry.update(t.ping(timeout=self._timeout))
                    entry["alive"] = True
                except (WorkerDeadError, RemoteCallError):
                    entry["alive"] = False
            out.append(entry)
        return out

    def take_worker_launches(self) -> dict:
        """Kernel launches inside the workers since the last take, summed
        ({"bag", "fused"}) and per worker (`per_worker`); zeroes each
        worker's counts. A worker that died since keeps none: a respawned
        process starts at zero."""
        self._require_built()
        outs = self._fan_out_retry(lambda w: self._call(w, "take_launches"),
                                   "take_launches")
        per = [outs[w] for w in sorted(outs)]
        return {"bag": sum(c["bag"] for c in per),
                "fused": sum(c["fused"] for c in per), "per_worker": per}

    def stats(self) -> dict:
        """One merged report under the exact `merge_shard_stats` law
        (`per_shard` holds one pre-merged entry per SHARD, multi-unit
        shards folded first), plus the pool's own accounting under
        `"pool"`: shared-host-tier bytes counted ONCE per host vs the
        per-worker private copies — the dedup headline."""
        self._require_built()
        outs = self._fan_out_retry(lambda w: self._call(w, "stats"),
                                   "stats")
        by_shard: dict[int, list[dict]] = {}
        host_bytes = private_bytes = 0
        for res in outs.values():
            host_bytes += res["host_tier_bytes"]
            private_bytes += res["private_tier_bytes"]
            for entry in res["units"].values():
                by_shard.setdefault(entry["shard"], []).append(
                    entry["stats"])
        per_shard = []
        for s in sorted(by_shard):
            group = by_shard[s]
            if len(group) == 1:
                per_shard.append(group[0])
            else:
                merged = merge_shard_stats(group)
                merged.pop("per_shard", None)
                merged.pop("num_shards", None)
                per_shard.append(merged)
        merged = merge_shard_stats(per_shard)
        shared = int(self._segment.size) if self._segment is not None else 0
        merged["pool"] = {
            "num_workers": len(self._transports),
            # the host's ONE shared cold-tier copy (counted once, however
            # many workers map it) + what workers privately duplicated
            "shared_host_bytes": shared,
            "host_view_bytes": int(host_bytes),
            "private_cold_bytes": int(private_bytes),
            "resident_cold_bytes": shared + int(private_bytes),
        }
        if not self._tenants:
            return merged
        # tenant-scoped shape, split from the SAME worker snapshots so
        # shared == fold of the tenant reports (the merge law, tenant axis)
        unit_tenant = {u.unit_id: u.tenant for u in self._units}
        entries: dict[str, list[dict]] = {n: [] for n in self._tenants}
        for res in outs.values():
            for uid, entry in res["units"].items():
                owner = unit_tenant.get(int(uid))
                if owner is not None:
                    entries[owner].append(entry)
        tenants = {name: self._merge_tenant_entries(name, entries[name])
                   for name in self._tenants}
        merged["device_bytes"] = sum(t["device_bytes"]
                                     for t in tenants.values())
        merged["num_tenants"] = len(tenants)
        return {"tenants": tenants, "shared": merged}

    def reset_stats(self) -> None:
        self._fan_out_retry(lambda w: self._call(w, "reset_stats"),
                            "reset_stats")
        for u in self._units:
            u.service_s, u.served_rows = 0.0, 0

    def flush(self) -> None:
        if self._units and not self._closed:
            self._fan_out_retry(lambda w: self._call(w, "flush"), "flush")
        self.window.clear()

    def close(self) -> None:
        """Stop every worker process, reclaim the shared segment, and
        clear the unit lists so a closed backend fails `_require_built`
        with a clear error. Idempotent; `build()` re-opens."""
        for t in self._transports:
            t.shutdown()
        if self._rpc_pool is not None:
            self._rpc_pool.shutdown(wait=True)
            self._rpc_pool = None
        if self._segment is not None:
            self._segment.close()
            try:
                self._segment.unlink()
            except FileNotFoundError:
                pass
            self._segment = None
        self._tables = None
        if self._transports:
            self._closed = True
        self._transports = []
        self._units = []
        self._worker_units = []
        self._routers = {}
        self._degraded = False
        self._tenants = {}
        self._tenant_hints = {}
        self._tenant_degraded = {}
        self._tenant_depth = {}
        self._update_txn = None
        self._tenant_txns = {}
        self.window.clear()
