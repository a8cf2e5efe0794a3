"""Tiered embedding parameter server (HugeCTR-HPS-shaped, paper-mechanized).

Three tiers per table, probed in order:

  hot  — device-resident block of the top-K rows, stored hot-first via a
         `hot_cache.HotPlan` permutation (tier-0; the paper's L2 pinning):
         ONE [T, K, D] tensor on the server's device (`_hot_dev`), copied
         table by table from the cold tier; the host keeps no second copy
         (at the production size it would be 6.4 GB).
  warm — fixed-capacity LFU/LRU row cache (tier-1), batched miss admission.
         `PSConfig.warm_backing="device"` keeps the payload on the device:
         ONE [T, C, D] tensor this server owns, each table's
         `DeviceWarmCache` holding its view.
  cold — full tables in host memory (tier-2), batched gathers, fronted by a
         prefetch stage that resolves future batches' misses early (the
         paper's software prefetching lifted to the memory hierarchy).
         `PSConfig.async_prefetch=True` moves those gathers onto a
         background worker thread with a double-buffered bounded queue
         (`AsyncPrefetcher`).

Every tier holds byte-identical copies of the same rows, so `lookup()` is
bit-exact with a dense `table[indices]` gather regardless of placement,
backing, or prefetch mode — only locality and overlap change. The fused
path (`lookup_fused`) is bit-identical to the device backend's pooled
output for f32 sum and unweighted mean: the fused kernel pools miss-free
bags with the embedding-bag kernel's arithmetic and bags that held a miss
are recomputed whole through the embedding-bag kernel itself.

A sliding window of observed traffic supports `refresh()`: re-plan the hot
set from recent batches (paper §IV-C) without touching served values,
split into a pure `plan_refresh()` (safe on a helper thread) and a
mutating `install_refresh()`.

Threading model: `lookup()`, `lookup_fused()`, `stage()`,
`refresh()`/`install_refresh()`, `flush()` and the stats methods must all be
called from ONE serving thread. The only concurrency is internal and
read-only: the async prefetch worker gathers from the immutable cold
tables, and `plan_refresh()` may run on a helper thread against a snapshot
of the traffic window.

A port of `repro/ps/server.py`. Where it differs: every table goes through
ONE fused launch (the TPU path launches once per table); a weighted mean
divides by max(Σw, 1e-9), as the port's device backend does (ROADMAP.md
Queue 3); the host's per-table row buffers come from
`cold_store.host_rows`, so a freed one leaves the process at once; and
`breakdown`, when set to a dict, collects the host-clock seconds of each
step of `lookup_fused`.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import hot_cache
from repro_torch.kernels.embedding_bag import fused
from repro_torch.ps.cold_store import ColdStore, host_rows, take_rows
from repro_torch.ps.config import PSConfig
from repro_torch.ps.prefetch import AsyncPrefetcher, PrefetchQueue, StagedBatch
from repro_torch.ps.warm_cache import (DeviceWarmCache, WarmCache,
                                       torch_dtype_of)
from repro_torch.utils import resolve_device


def _release_staged(staged: StagedBatch | None, table: int) -> None:
    """Drop one table's staged payload once the lookup has taken its rows
    (`split_misses` copies them), so a consumed batch's payload leaves the
    host table by table while the prefetch worker fills the next one."""
    if staged is not None:
        staged.data.pop(table, None)


class ParameterServer:
    """lookup(indices [B, T, L]) -> rows [B, T, L, D] (host, bit-exact);
    lookup_fused(indices) -> pooled [B, T, D] on `device`."""

    def __init__(self, tables, cfg: PSConfig,
                 plans: list[hot_cache.HotPlan] | None = None,
                 trace: np.ndarray | None = None, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if torch.is_tensor(tables):
            tables = tables.numpy()       # a host tensor's bytes, not a copy
        self.cold = ColdStore(np.asarray(tables))
        T, R, D = self.cold.tables.shape
        k = min(cfg.hot_rows, R)
        if plans is None:
            if trace is not None and k > 0:
                plans = [hot_cache.plan_from_trace(trace[:, t], R, k)
                         for t in range(T)]
            else:
                plans = [hot_cache.identity_plan(R, k) for _ in range(T)]
        assert len(plans) == T
        self.plans = plans
        self._make_warm(cfg.warm_slots)
        # depth 0 disables staging entirely — don't spawn a worker thread
        # that could never receive work
        if cfg.async_prefetch and cfg.prefetch_depth > 0:
            self.prefetch = AsyncPrefetcher(cfg.prefetch_depth,
                                            self.cold.gather)
        else:
            self.prefetch = PrefetchQueue(cfg.prefetch_depth,
                                          self.cold.gather)
        self.window: collections.deque[np.ndarray] = collections.deque(
            maxlen=cfg.window_batches)
        self.hot_hits = 0
        self.total_accesses = 0
        self.refreshes = 0
        # degraded (warm-cache-only) overload mode: cold misses are
        # zero-filled instead of gathered — see set_degraded()
        self.degraded_mode = False
        self.degraded_lookups = 0
        self.degraded_rows = 0          # zero-filled row ACCESSES
        self.degraded_l2_sq = 0.0       # exact Σ ||row||² over those
        # one-shot hint from the serving layer: only the first N queries of
        # the next lookup are real traffic (the rest is batcher padding)
        self._valid_hint: int | None = None
        # online model updates: committed version + the (at most one) open
        # buffered transaction — see the "online model updates" section
        self._version = 0
        self._update_txn = None
        # set to a dict to collect lookup_fused's per-step seconds (the
        # device is synchronised at every step boundary while it is set)
        self.breakdown: dict | None = None
        self._install_hot_tier()

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Stop the async prefetch worker (no-op in sync mode). Idempotent;
        the server remains usable for sync lookups afterwards only if it
        was constructed without `async_prefetch`."""
        self.prefetch.close()

    def __enter__(self) -> "ParameterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- tiers --------------------------------------------------------------
    def _make_warm(self, slots: int) -> None:
        """(Re)allocate the warm tier: per-table tag stores, and with device
        backing one [T, C, D] payload whose per-table views back them."""
        T, _, D = self.cold.tables.shape
        dtype = self.cold.tables.dtype
        self._warm_payload = None
        if self.cfg.warm_backing == "device":
            self._warm_payload = torch.zeros(
                (T, slots, D), dtype=torch_dtype_of(dtype),
                device=self.device)
            self.warm = [DeviceWarmCache(slots, D, self.cfg.eviction, dtype,
                                         payload=self._warm_payload[t])
                         for t in range(T)]
        else:
            self.warm = [WarmCache(slots, D, self.cfg.eviction, dtype)
                         for _ in range(T)]

    def _install_hot_tier(self) -> None:
        T, R, D = self.cold.tables.shape
        k = min(self.cfg.hot_rows, R)
        self.num_hot = k
        if k > 0:
            # the plans' own arrays, not a stacked copy
            self._inv_perm = [p.inv_perm for p in self.plans]
            self._hot_dev = torch.empty(
                (T, k, D), dtype=torch_dtype_of(self.cold.tables.dtype),
                device=self.device)
            for t in range(T):
                self._hot_dev[t] = torch.from_numpy(
                    self.cold.hot_block(t, self.plans[t].perm[:k]))
        else:
            self._inv_perm = None
            self._hot_dev = None

    # -- lookup -------------------------------------------------------------
    def _lookup_table(self, t: int, flat: np.ndarray,
                      staged: StagedBatch | None) -> np.ndarray:
        """flat [N] raw row ids for table t -> [N, D].

        Tier probe order and invariants:
          1. hot — positional test `inv_perm[row] < num_hot`; hot payloads
             come from the pinned block, never the warm/cold tiers.
          2. warm — probed with the DISTINCT missed rows (`np.unique`), so
             hit/miss counters are per-row, and intra-batch duplicates of a
             missed row count one miss + (count-1) hits.
          3. cold — the remaining misses split into rows already staged by
             the prefetch engine (payload gathered earlier, possibly on the
             worker thread) and residual rows gathered right here, on the
             critical path.
        All three sources hold byte-identical row values (the cold store is
        authoritative; hot/warm are copies), which is the bit-exactness
        invariant the tests pin down.
        """
        D = self.cold.dim
        out = np.empty((flat.size, D), self.cold.tables.dtype)
        if self.num_hot > 0:
            pos = self._inv_perm[t][flat]
            hot = pos < self.num_hot
            out[hot] = self._hot_dev[t].index_select(
                0, torch.from_numpy(pos[hot]).to(self.device)).cpu().numpy()
            self.hot_hits += int(hot.sum())
            cold_idx = np.flatnonzero(~hot)
        else:
            cold_idx = np.arange(flat.size)
        if cold_idx.size == 0:
            return out

        rows = flat[cold_idx]
        u, inv, counts = np.unique(rows, return_inverse=True,
                                   return_counts=True)
        warm = self.warm[t]
        slots = warm.probe(u)
        resident = slots >= 0
        vals = np.empty((len(u), D), self.cold.tables.dtype)
        if resident.any():
            warm.touch(slots[resident], counts[resident])
            vals[resident] = warm.read(slots[resident])
        if (~resident).any():
            mu, mcounts = u[~resident], counts[~resident]
            if self.degraded_mode:
                # warm-cache-only overload mode: zero-fill instead of
                # gathering, and NEVER admit the zeros into the warm tier
                # (a poisoned entry would break bit-exactness after the
                # mode lifts). Tier access accounting stays identical to
                # admit()'s (first access = miss, duplicates = hits) so
                # the hot+warm+cold == total invariant survives; the
                # degraded counters ride on top, with the exact L2 error
                # of each zero-fill from the zero-filled rows' norms.
                vals[~resident] = 0
                warm.misses += len(mu)
                warm.hits += int(mcounts.sum()) - len(mu)
                self.degraded_rows += int(mcounts.sum())
                self.degraded_l2_sq += float(
                    (self.cold.row_norms_sq(t, mu) * mcounts).sum())
            else:
                srows, sdata, residual = self.prefetch.split_misses(
                    staged, t, mu)
                _release_staged(staged, t)
                payload = host_rows(len(mu), D, self.cold.tables.dtype)
                if residual.size:
                    rdata = self.cold.gather(t, residual)
                # mu is sorted; scatter staged + residual payloads back
                if srows.size:
                    payload[np.searchsorted(mu, srows)] = sdata
                if residual.size:
                    payload[np.searchsorted(mu, residual)] = rdata
                vals[~resident] = payload
                # admit hottest-first so capacity truncation keeps the
                # best rows
                order = np.lexsort((mu, -mcounts))
                warm.admit(mu[order], take_rows(payload, order),
                           mcounts[order])
        out[cold_idx] = vals[inv]
        return out

    def hint_valid(self, n: int) -> None:
        """Mark only the first `n` queries of the NEXT lookup as real
        traffic. The serving batcher pads partial batches to max_batch with
        zero queries for shape stability; without this hint those fabricated
        row-0 accesses would inflate hit rates and skew refresh planning."""
        self._valid_hint = int(n)

    def lookup(self, indices: np.ndarray) -> np.ndarray:
        """indices [B, T, L] raw row ids -> rows [B, T, L, D] (host numpy).

        Consumes the matching staged batch if one exists (in async mode
        this may wait on — or inline-resolve — a buffer the worker has not
        finished; the wait is recorded in the overlap stats). Appends the
        real-traffic slice to the refresh window and updates counters.
        """
        indices = np.asarray(indices)
        B, T, L = indices.shape
        assert T == self.cold.num_tables
        valid, self._valid_hint = self._valid_hint, None
        if valid is not None and valid < B:
            # padding rows: serve values directly (uncounted, not cached).
            # An all-padding batch (valid=0) takes this path alone: no
            # zero-size recursion, no window/counter pollution.
            pad = self.cold.tables[np.arange(T)[None, :, None],
                                   indices[valid:]]
            if valid == 0:
                return pad
            real = self.lookup(indices[:valid])
            return np.concatenate([real, pad], axis=0)
        if self.degraded_mode:
            # no staged batches exist while degraded (entering the mode
            # flushed the queue and can_stage() is gated off), so there is
            # nothing to consume — and consuming would risk waiting on a
            # worker, exactly the latency the mode exists to avoid
            staged = None
            self.degraded_lookups += 1
        else:
            staged = self.prefetch.consume(indices)
        self.window.append(indices)
        self.total_accesses += indices.size
        out = np.empty((B, T, L, self.cold.dim), self.cold.tables.dtype)
        for t in range(T):
            out[:, t] = self._lookup_table(
                t, indices[:, t].ravel(), staged).reshape(B, L, -1)
        return out

    # -- fused lookup --------------------------------------------------------
    def supports_fused(self) -> bool:
        """True when the fused kernel path can serve: the flag is on and
        every warm payload is device-resident."""
        return (self.cfg.fused_lookup
                and all(w.supports_fused for w in self.warm))

    @contextlib.contextmanager
    def _timed(self, step: str):
        """Add the step's host-clock seconds to `breakdown` when it is set,
        with the device synchronised at both ends."""
        if self.breakdown is None:
            yield
            return
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda *_: None))
        sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.breakdown[step] = (self.breakdown.get(step, 0.0)
                                    + time.perf_counter() - t0)

    def pool_rows(self, rows: np.ndarray, weights, combine: str
                  ) -> torch.Tensor:
        """Pool raw rows [B, T, L, D] (+ weights [B, T, L]) -> [B, T, D] on
        the server's device, each bag exactly as the device backend pools
        it (`fused.pool_bag_rows`: the embedding-bag kernel on the card,
        `_pool_rows_core`'s reduction on the CPU)."""
        B, T, L, D = rows.shape
        w = None if weights is None else np.asarray(
            weights, np.float32).reshape(B * T, L)
        pooled = fused.pool_bag_rows(rows.reshape(B * T, L, D), w,
                                     mode=combine, device=self.device)
        return pooled.view(B, T, D)

    def build_slot_map(self, indices: np.ndarray, *,
                       account: bool = False) -> np.ndarray:
        """indices [B, T, L] raw ids -> the fused kernel's slot map
        [B, T, L] int32: hot positions first, then the warm tag store
        (offset by num_hot), MISS everywhere else.

        With `account=False` a pure tag-store read (no counter moves);
        `lookup_fused` passes True, which counts the hot hits and touches
        the resident warm slots."""
        B, T, L = indices.shape
        slot_map = np.full((B, T, L), fused.MISS, np.int32)
        for t in range(T):
            flat = indices[:, t].ravel()
            sm = np.full(flat.size, fused.MISS, np.int64)
            if self.num_hot > 0:
                pos = self._inv_perm[t][flat]
                hot_mask = pos < self.num_hot
                sm[hot_mask] = pos[hot_mask]
                if account:
                    self.hot_hits += int(hot_mask.sum())
                rest = np.flatnonzero(~hot_mask)
            else:
                rest = np.arange(flat.size)
            if rest.size:
                u, inv, counts = np.unique(flat[rest], return_inverse=True,
                                           return_counts=True)
                warm = self.warm[t]
                slots = warm.probe(u)
                resident = slots >= 0
                if account and resident.any():
                    warm.touch(slots[resident], counts[resident])
                sm[rest] = np.where(resident, self.num_hot + slots,
                                    fused.MISS)[inv]
            slot_map[:, t] = sm.reshape(B, L)
        return slot_map

    def lookup_fused(self, indices: np.ndarray, weights=None, *,
                     combine: str = "sum") -> torch.Tensor:
        """indices [B, T, L] (+ optional weights [B, T, L]) -> pooled
        [B, T, D] on the server's device.

        The host builds the slot map of every table (hot positions, then
        the warm tag store, MISS elsewhere); ONE fused launch over the
        device warm payload and hot block does hit gather + pooled sum +
        miss-list emission for all tables; only the emitted misses then
        touch the host cold path (gather + admit + whole-bag recompute via
        `complete_miss_bags`). The mean is an eager epilogue.

        Counter/window/staging semantics mirror `lookup()` exactly: the
        valid-hint padding block is served uncounted, staged prefetch
        payloads are consumed, and degraded mode answers with the kernel's
        zero-contribution partial output (misses tallied with their exact
        L2 delta, the warm tier never polluted).
        """
        if not self.supports_fused():
            raise RuntimeError(
                "lookup_fused needs cfg.fused_lookup=True and a "
                "device-resident warm payload (warm_backing='device'); "
                "use lookup() otherwise")
        if combine not in ("sum", "mean"):
            raise ValueError(f"unknown combine {combine!r}")
        indices = np.asarray(indices)
        B, T, L = indices.shape
        assert T == self.cold.num_tables
        valid, self._valid_hint = self._valid_hint, None
        if valid is not None and valid < B:
            # padding rows: pooled directly from the cold tables
            # (uncounted, not cached) — the fused analogue of lookup()'s
            # padding block
            pad_rows = self.cold.tables[np.arange(T)[None, :, None],
                                        indices[valid:]]
            pad_pooled = self.pool_rows(
                pad_rows, None if weights is None else weights[valid:],
                combine)
            if valid == 0:
                return pad_pooled
            real = self.lookup_fused(
                indices[:valid],
                None if weights is None else weights[:valid],
                combine=combine)
            return torch.cat([real, pad_pooled], dim=0)

        if self.degraded_mode:
            staged = None
            self.degraded_lookups += 1
        else:
            staged = self.prefetch.consume(indices)
        self.window.append(indices)
        self.total_accesses += indices.size

        dev = self.device
        with self._timed("slot_map"):
            slot_map = self.build_slot_map(indices, account=True)
        with self._timed("slot_map_copy"):
            slots_d = torch.from_numpy(slot_map).to(dev)
            rows_d = torch.from_numpy(
                np.ascontiguousarray(indices, np.int32)).to(dev)
            w_d = None if weights is None else torch.from_numpy(
                np.ascontiguousarray(weights, np.float32)).to(dev)
        operands = (self._warm_payload, slots_d, rows_d, w_d,
                    self._hot_dev if self.num_hot > 0 else None)
        if dev.type == "cuda":
            with self._timed("fused_kernel"):
                pooled, mrow, mpos, counts = fused.launch_tables(
                    *operands, self.cold.num_rows, fused.FusedLookupOpts())
            with self._timed("miss_list_copy"):
                miss_rows, miss_pos = fused.lists_to_host(mrow, mpos, counts)
        else:
            pooled, miss_rows, miss_pos = fused.fused_warm_lookup_tables(
                *operands, num_rows=self.cold.num_rows)

        D = self.cold.dim
        for t in range(T):
            if not miss_rows[t].size:
                continue
            warm = self.warm[t]
            rows_bl = indices[:, t]                        # [B, L]
            flat = rows_bl.ravel()
            # the kernel's compact miss list drives the cold path
            mu = miss_rows[t].astype(np.int64)
            _, mcounts = np.unique(flat[miss_pos[t]],
                                   return_counts=True)     # aligned: sorted
            if self.degraded_mode:
                # zero-contribution partial output IS the degraded answer;
                # account like _lookup_table's degraded branch
                warm.misses += len(mu)
                warm.hits += int(mcounts.sum()) - len(mu)
                self.degraded_rows += int(mcounts.sum())
                self.degraded_l2_sq += float(
                    (self.cold.row_norms_sq(t, mu) * mcounts).sum())
                continue
            with self._timed("cold_gather"):
                srows, sdata, residual = self.prefetch.split_misses(
                    staged, t, mu)
                _release_staged(staged, t)
                payload = host_rows(len(mu), D, self.cold.tables.dtype)
                if srows.size:
                    payload[np.searchsorted(mu, srows)] = sdata
                if residual.size:
                    payload[np.searchsorted(mu, residual)] = \
                        self.cold.gather(t, residual)
            with self._timed("admission"):
                order = np.lexsort((mu, -mcounts))
                warm.admit(mu[order], take_rows(payload, order),
                           mcounts[order])
            # whole-bag recompute (never add-to-partial: summation order
            # must match the dense path). Hit positions re-read the
            # authoritative cold copy — every tier holds identical bytes,
            # so values cannot differ
            bags = np.unique(miss_pos[t] // L)
            with self._timed("completion_gather"):
                # torch's host index_select gathers on every core
                bag_rows = torch.from_numpy(self.cold.tables[t]).index_select(
                    0, torch.from_numpy(rows_bl[bags].ravel()).long()
                ).view(bags.size, L, D)
            with self._timed("completion_copy"):
                bag_rows = bag_rows.to(dev)
            with self._timed("completion_kernel"):
                pooled[:, t] = fused.complete_miss_bags(
                    pooled[:, t], bags, bag_rows,
                    None if w_d is None else w_d[:, t], mode="sum")
        return fused.mean_epilogue(pooled, w_d, L, combine)

    # -- degraded (warm-cache-only) overload mode ----------------------------
    def degraded(self) -> bool:
        return self.degraded_mode

    def set_degraded(self, on: bool) -> bool:
        """Toggle warm-cache-only serving (the overload escape hatch).

        While on: lookups serve hot/warm hits exactly as usual but
        ZERO-FILL cold misses instead of gathering them, and no new
        prefetch work starts (`can_stage()` gates off). Entering the mode
        flushes staged batches — their payloads describe batches that will
        now be answered degraded, and a stale staged batch would pin a
        queue slot forever once staging resumes. Leaving the mode restores
        bit-exact serving immediately: the warm tier is never polluted
        with zeros, and staging re-enables on the next probe. The zeroed
        accesses are tallied (`degraded_rows`) together with their exact
        L2 error vs the dense gather (`degraded_l2_delta` in stats()).
        Returns True (the toggle is always available on a live server)."""
        on = bool(on)
        if on and not self.degraded_mode:
            self.prefetch.flush()
        self.degraded_mode = on
        return True

    # -- prefetch -----------------------------------------------------------
    def can_stage(self) -> bool:
        """Backpressure probe for callers that would otherwise do assembly
        work just to have stage() discard it (queue full / staging off /
        degraded mode — no new cold work while shedding load)."""
        return not self.degraded_mode and self.prefetch.can_stage()

    def stage(self, indices: np.ndarray) -> bool:
        """Pre-resolve a FUTURE batch's cold misses (overlap analogue).

        The hot/warm probe runs here, on the caller thread, against current
        tier state — that snapshot is what makes the operation safe: the
        staged row set is frozen before any concurrent work starts. The
        cold gathers for those rows then run either inline (sync engine) or
        on the prefetch worker (async engine, double-buffered). `lookup()`
        later consumes the staged payload instead of touching the cold
        store on the critical path.

        Always correctness-neutral: rows admitted to warm (or re-pinned
        hot) between stage and consume are simply unused, and rows evicted
        in between fall through to a residual cold gather. Returns False
        (and performs no gather work) when the queue is full — the
        backpressure signal.
        """
        if not self.can_stage():
            return False    # queue full / degraded: don't probe for a discard
        indices = np.asarray(indices)
        rows: dict[int, np.ndarray] = {}
        for t in range(self.cold.num_tables):
            flat = indices[:, t].ravel()
            if self.num_hot > 0:
                flat = flat[self._inv_perm[t][flat] >= self.num_hot]
            u = np.unique(flat)
            miss = u[self.warm[t].probe(u) < 0]
            if miss.size:
                rows[t] = miss
        return self.prefetch.stage(StagedBatch(indices, rows, {}))

    def flush(self) -> None:
        """Drop cached state — warm entries, the traffic window, staged
        batches (in-flight async buffers are cancelled) — without touching
        the hot tier, plans, or counters. Use after synthetic traffic
        (e.g. jit warmup batches) so it cannot linger in the warm cache or
        skew the next refresh()."""
        for w in self.warm:
            w.clear()
        self.window.clear()
        self.prefetch.flush()

    # -- runtime tuning -----------------------------------------------------
    def set_prefetch_depth(self, depth: int) -> None:
        """Move the prefetch engine's bounded-buffer depth (see
        `prefetch.set_depth`). The staging ENGINE never changes — an
        async-built server keeps its worker thread, a sync-built one stays
        sync — only the backpressure bound moves."""
        self.prefetch.set_depth(depth)
        self.cfg = dataclasses.replace(self.cfg,
                                       prefetch_depth=self.prefetch.depth)

    def resize_tiers(self, hot_rows: int, warm_slots: int) -> None:
        """Re-size the hot and warm tiers in place (serving thread only).

        The hot plans are full permutations, so a new `hot_rows` is just a
        new cut point — `_install_hot_tier` rebuilds the pinned block from
        the existing plans (re-plan from the window separately via
        `refresh()` if wanted). Warm caches are only rebuilt when their
        capacity actually changes; a rebuild drops cached entries (they
        re-admit from traffic) but keeps cumulative counters.
        """
        hot_rows = max(0, int(hot_rows))
        warm_slots = max(0, int(warm_slots))
        if warm_slots != self.cfg.warm_slots:
            old = self.warm
            self._make_warm(warm_slots)
            for w_new, w_old in zip(self.warm, old):
                w_new.hits, w_new.misses = w_old.hits, w_old.misses
                w_new.evictions = w_old.evictions
                w_new.insertions = w_old.insertions
        self.cfg = dataclasses.replace(self.cfg, hot_rows=hot_rows,
                                       warm_slots=warm_slots)
        self._install_hot_tier()
        for t, w in enumerate(self.warm):
            # a row lives in at most one device tier (install_refresh law)
            w.invalidate(self.plans[t].perm[:self.num_hot])
        # staged payloads are keyed by raw row id and re-checked against
        # the tiers at consume time, so the queue stays valid

    def retune(self, budget_bytes: int) -> dict | None:
        """Planner-fed capacity retune: size hot/warm from the LIVE sliding
        window under `budget_bytes` (`core.plan.plan_tier_capacities` with
        a headroom estimate instead of a static byte count). Returns the
        applied sizes, or None when the window is empty (nothing to plan
        from) — tier state is then left untouched.
        """
        if not self.window:
            return None
        from repro_torch.core.plan import plan_tier_capacities
        trace = np.concatenate(
            [w.reshape(w.shape[0], w.shape[1], -1) for w in self.window],
            axis=0)
        plan = plan_tier_capacities(trace, self.cold.num_rows,
                                    self.cold.dim, budget_bytes,
                                    itemsize=self.cold.tables.dtype.itemsize)
        if (plan.hot_rows, plan.warm_slots) != (self.cfg.hot_rows,
                                                self.cfg.warm_slots):
            self.resize_tiers(plan.hot_rows, plan.warm_slots)
        return {"hot_rows": self.cfg.hot_rows,
                "warm_slots": self.cfg.warm_slots,
                "budget_bytes": int(budget_bytes),
                "plan_coverage": plan.total_coverage}

    # -- periodic re-pinning ------------------------------------------------
    def plan_refresh(self, window: list[np.ndarray] | None = None
                     ) -> list[hot_cache.HotPlan] | None:
        """Phase 1 of refresh: re-plan the hot set from a traffic window.

        Pure function of its inputs — no server state is mutated — so the
        serving layer may run it on a helper thread against
        `list(ps.window)` snapshotted on the serving thread. Returns None
        when there is nothing to plan from (empty window or no hot tier).
        """
        window = list(self.window) if window is None else window
        if not window or self.num_hot == 0:
            return None
        trace = np.concatenate([w.reshape(w.shape[0], w.shape[1], -1)
                                for w in window], axis=0)  # [N, T, L]
        R = self.cold.num_rows
        return [hot_cache.plan_from_trace(trace[:, t], R, self.num_hot)
                for t in range(self.cold.num_tables)]

    def install_refresh(self, plans: list[hot_cache.HotPlan] | None) -> dict:
        """Phase 2 of refresh: swap the planned hot set in (serving thread
        ONLY — mutates the hot block, the warm tag stores, and the plans).

        Invariants: served values never change (every tier holds the same
        bytes); warm entries for newly-pinned rows are invalidated so a row
        lives in at most one device tier; staged prefetch payloads remain
        valid because they are keyed by raw row id.
        """
        if plans is None:
            if self.cfg.freq_decay < 1.0:
                for w in self.warm:
                    w.decay(self.cfg.freq_decay)
            return {"replanned": False, "refreshes": self.refreshes}
        self.plans = plans
        self._install_hot_tier()
        for t, w in enumerate(self.warm):
            w.invalidate(self.plans[t].perm[:self.num_hot])
            if self.cfg.freq_decay < 1.0:
                w.decay(self.cfg.freq_decay)
        # staged payloads remain valid (keyed by raw row id); keep the queue
        self.refreshes += 1
        return {"replanned": True, "refreshes": self.refreshes}

    def refresh(self) -> dict:
        """Re-plan + install the hot tier from the sliding window (§IV-C).
        The synchronous driver; see plan_refresh/install_refresh for the
        split the async serving driver uses."""
        return self.install_refresh(self.plan_refresh())

    # -- online model updates ------------------------------------------------
    def version(self) -> int:
        """Committed model version (0 = construction-time weights)."""
        return self._version

    def begin_update(self, version: int) -> bool:
        """Open a buffered update transaction targeting `version`. Rows
        applied into it stay invisible to lookups until `commit_update` —
        the buffer is the shadow copy of changed rows."""
        from repro_torch.core.update import UpdateTxn
        if self._update_txn is not None:
            raise RuntimeError(
                f"an update to v{self._update_txn.version} is already "
                f"open — commit or abort it first")
        self._update_txn = UpdateTxn(version, self._version)
        return True

    def apply_update(self, table: int, rows: np.ndarray,
                     values: np.ndarray) -> bool:
        from repro_torch.core.update import require_open
        require_open(self._update_txn, "apply_update").add(
            table, rows, values, num_tables=self.cold.num_tables,
            num_rows=self.cold.num_rows, dim=self.cold.dim,
            dtype=self.cold.tables.dtype)
        return True

    def _install_update_rows(self, merged: dict, *,
                             write_cold: bool = True) -> int:
        """Tier maintenance for COMMITTED update rows (table -> (rows,
        values), table ids local to this server). Serving thread only.

        Order matters: the prefetch queue is flushed FIRST (staged
        payloads are keyed by raw row id but hold the OLD bytes — a
        later consume must never serve the previous version), then the
        cold tables take the new rows, warm entries for touched rows are
        invalidated (they re-admit from traffic with the new bytes), and
        hot-pinned touched rows are re-copied into the hot block in
        place. `write_cold=False` is for a cold tier
        whose bytes were already written underneath it: only the caches
        need fixing (and the norm cache still drops)."""
        applied = 0
        self.prefetch.flush()
        for t, (rows, vals) in merged.items():
            if write_cold:
                self.cold.update_rows(t, rows, vals)
            else:
                self.cold.drop_norm_cache()
            self.warm[t].invalidate(rows)
            if self.num_hot > 0:
                pos = self._inv_perm[t][rows]
                hot = pos < self.num_hot
                if hot.any():
                    self._hot_dev[t].index_copy_(
                        0, torch.from_numpy(pos[hot]).to(self.device),
                        torch.from_numpy(self.cold.tables[t, rows[hot]])
                        .to(self.device))
            applied += int(rows.size)
        return applied

    def commit_update(self, version: int) -> dict:
        """Publish the open transaction: flush stale staged payloads,
        write the cold rows, invalidate/re-pin touched cache entries.
        Runs between batches on the serving thread, so the swap is atomic
        with respect to lookups by construction."""
        from repro_torch.core.update import require_open
        txn = require_open(self._update_txn, "commit_update")
        txn.check_commit(version)
        merged = txn.merged()
        applied = self._install_update_rows(merged)
        self._version = txn.version
        self._update_txn = None
        return {"updated": True, "version": self._version,
                "rows": applied, "tables": len(merged)}

    def abort_update(self, version: int) -> bool:
        """Drop the open transaction (if any); the committed version keeps
        serving untouched — no tier was modified by begin/apply."""
        if self._update_txn is None:
            return False
        self._update_txn.check_commit(version)
        self._update_txn = None
        return True

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        """Counter snapshot. Tier counters satisfy
        `hot_hits + warm_hits + cold_misses == total_accesses`; the
        prefetch engine contributes staging/overlap counters (see
        `prefetch.stats()`), including `off_critical_frac` — the fraction
        of cold-missed rows whose gather never ran on the lookup path."""
        warm_hits = sum(w.hits for w in self.warm)
        warm_misses = sum(w.misses for w in self.warm)
        total = self.total_accesses
        s = {
            "total_accesses": total,
            "hot_hits": self.hot_hits,
            "warm_hits": warm_hits,
            "cold_misses": warm_misses,
            "evictions": sum(w.evictions for w in self.warm),
            "insertions": sum(w.insertions for w in self.warm),
            "warm_occupancy": sum(len(w) for w in self.warm),
            "refreshes": self.refreshes,
            "hot_hit_rate": self.hot_hits / total if total else 0.0,
            "warm_hit_rate": warm_hits / total if total else 0.0,
            "cold_miss_rate": warm_misses / total if total else 0.0,
            "cache_hit_rate": (self.hot_hits + warm_hits) / total
                              if total else 0.0,
            "cold_gathered_rows": self.cold.gathered_rows,
            # degraded (warm-cache-only) serving: zero-filled accesses and
            # their exact L2 error vs the dense gather. `degraded_l2_sq`
            # is the mergeable raw sum; the delta is derived from it.
            "degraded_lookups": self.degraded_lookups,
            "degraded_rows": self.degraded_rows,
            "degraded_l2_sq": self.degraded_l2_sq,
            "degraded_l2_delta": float(np.sqrt(self.degraded_l2_sq)),
        }
        s.update(self.prefetch.stats())
        return s

    def reset_stats(self) -> None:
        self.hot_hits = 0
        self.total_accesses = 0
        self.degraded_lookups = 0
        self.degraded_rows = 0
        self.degraded_l2_sq = 0.0
        for w in self.warm:
            w.hits = w.misses = w.evictions = w.insertions = 0
        self.cold.reset_counters()
        self.prefetch.reset()
