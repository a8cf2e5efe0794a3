"""Pool worker process: ParameterServer units behind the framed RPC.

`worker_main` is the spawn target. One worker hosts one `ParameterServer`
per placement unit assigned to it (a shard's non-replicated table group,
or one replica of a replicated table — the same unit decomposition
`ShardedStorage` runs on threads) and speaks the full `EmbeddingStorage`
verb set over the pipe, plus lifecycle verbs:

  attach_tables      — map the host's ONE shared-memory copy of the cold
                       tables (created by the pool at build()).
  construct          — build this worker's units and start serving them.
  construct_pending / commit_pending / abort_pending
                     — the two halves of the cross-process
                       build-before-teardown swap: a migration's new units
                       are fully constructed on every worker FIRST
                       (serving untouched), then committed everywhere —
                       or aborted everywhere, leaving the old units live.
  ping / shutdown    — heartbeat and clean exit.

Shared host cold tier: a unit whose table ids form one ascending
contiguous run is served a zero-copy VIEW into the shared segment
(`ColdStore` keeps contiguous input as-is), so its cold tier costs this
worker nothing — N workers replicating a hot table share ONE host copy of
its rows, and only the per-worker hot/warm device caches duplicate.
Non-contiguous table groups fall back to a private gather copy; `stats`
reports both byte counts so the dedup is measurable.

Multi-tenant pools scope the shared verbs per tenant WITHOUT the worker
knowing tenant names: the pool translates a tenant into the unit ids it
owns on this worker and passes `unit_ids=` to the stats / flush /
degraded / depth / refresh verbs (None keeps the whole-worker behavior).
Tenant table runs are contiguous by namespace construction, so tenant
units keep the zero-copy shared-segment views.

Errors: a verb that raises is answered with an `err` frame (type, message,
traceback) and the worker keeps serving — only pipe loss or `shutdown`
ends the loop. A failed kernel build or launch is such an error: it
reaches the pool as `RemoteCallError`, never as a plain-version answer.

A port of `repro/storage/pool/worker.py`. Where it differs: each unit's
`ParameterServer` lives on the device its spec names (`"cuda"` by
default: each worker process owns a CUDA context, and a worker asked for
`cuda` where there is no card raises); the worker launches the CUDA
kernels itself, so `ping` also reports this process's launch counts and,
on the card, its peak device bytes (`take_launches` reads and zeroes the
counts); fused blocks come back as host numpy (`utils.host_array`: a
bfloat16 block as its 16-bit patterns); hot plans arrive as plain dicts
of arrays, so they ride shared memory; and `attach_tables` sets the
process's intra-op thread count, which the pool divides among its workers
(N workers at torch's default of one thread a core would oversubscribe
the host N times).
"""
from __future__ import annotations

import os
import time
import traceback
import warnings

import numpy as np
import torch

from repro_torch.storage.pool.transport import (attach_segment,
                                                decode_payload,
                                                encode_payload,
                                                release_segments)
from repro_torch.utils import host_array


class _WorkerUnit:
    """One hosted ParameterServer + its placement coordinates."""

    def __init__(self, unit_id: int, shard: int, table_ids: np.ndarray,
                 chunk, ps, host_bytes: int, private_bytes: int):
        self.unit_id = unit_id
        self.shard = shard
        self.table_ids = table_ids
        self.chunk = chunk
        self.ps = ps
        self.host_bytes = host_bytes          # cold tier served as shm view
        self.private_bytes = private_bytes    # cold tier privately copied


def _is_contiguous_run(ids: np.ndarray) -> bool:
    return bool(ids.size) and ids[-1] - ids[0] + 1 == ids.size and \
        bool(np.all(np.diff(ids) == 1))


class _WorkerState:
    def __init__(self, worker: int):
        self.worker = worker
        self.units: dict[int, _WorkerUnit] = {}
        self.pending: dict[int, _WorkerUnit] | None = None
        self.segment = None                   # shared cold-table segment
        self.tables = None                    # [T, R, D] view over it
        self.degraded = False
        self.pending_update = None            # (version, {t: (rows, vals)})

    # -- lifecycle ----------------------------------------------------------
    def do_ping(self):
        """Heartbeat, plus this process's kernel launch counts and (once
        it has touched the card) its peak device bytes."""
        from repro_torch.kernels.embedding_bag import fused, kernel
        out = {"worker": self.worker, "pid": os.getpid(),
               "units": sorted(self.units),
               "shards": sorted({u.shard for u in self.units.values()}),
               "degraded": self.degraded,
               "launches": {"bag": kernel.LAUNCHES,
                            "fused": fused.LAUNCHES}}
        if torch.cuda.is_initialized():
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        return out

    def do_take_launches(self):
        """This process's launch counts since the last take; zeroes
        them."""
        from repro_torch.kernels.embedding_bag import fused, kernel
        out = {"bag": kernel.LAUNCHES, "fused": fused.LAUNCHES}
        kernel.LAUNCHES = fused.LAUNCHES = 0
        return out

    def do_attach_tables(self, name, dtype, shape, threads=None):
        if threads is not None:
            torch.set_num_threads(int(threads))
        if self.segment is not None:
            self.segment.close()
        self.segment = attach_segment(name)
        self.tables = np.ndarray(tuple(shape), np.dtype(dtype),
                                 buffer=self.segment.buf)
        self.tables.flags.writeable = False   # the cold tier is read-only
        return {"attached": name, "nbytes": int(self.tables.nbytes),
                "threads": torch.get_num_threads()}

    def _build_units(self, unit_specs, ps_cfg, plans_by_table):
        """Construct ParameterServers for `unit_specs` without touching the
        serving units; on any failure, close what was built and re-raise."""
        from repro_torch.core.hot_cache import HotPlan
        from repro_torch.ps import ParameterServer
        if self.tables is None:
            raise RuntimeError(f"worker {self.worker}: attach_tables must "
                               f"run before construct")
        built: dict[int, _WorkerUnit] = {}
        try:
            for spec in unit_specs:
                ids = np.asarray(spec["table_ids"], np.int64)
                if _is_contiguous_run(ids):
                    # zero-copy slice of the shared host tier: ColdStore
                    # keeps contiguous input as-is, so the cold rows are
                    # never duplicated into this process
                    tabs = self.tables[int(ids[0]):int(ids[-1]) + 1]
                    host, priv = int(tabs.nbytes), 0
                else:
                    tabs = self.tables[ids]   # private gather copy
                    host, priv = 0, int(tabs.nbytes)
                plans = (None if plans_by_table is None
                         else [HotPlan(**plans_by_table[int(t)])
                               for t in ids])
                ps = ParameterServer(tabs, ps_cfg, plans=plans,
                                     device=spec.get("device", "cuda"))
                built[int(spec["unit_id"])] = _WorkerUnit(
                    int(spec["unit_id"]), int(spec["shard"]), ids,
                    spec["chunk"], ps, host, priv)
        except BaseException:
            for u in built.values():
                u.ps.close()
            raise
        return built

    def do_construct(self, units, ps_cfg, plans_by_table=None,
                     degraded=False, prefetch_depth=None):
        """Build + immediately serve (initial build / crash respawn)."""
        built = self._build_units(units, ps_cfg, plans_by_table)
        old = self.units
        self.units = built
        self.degraded = bool(degraded)
        for u in built.values():
            if self.degraded:
                u.ps.set_degraded(True)
            if prefetch_depth is not None:
                u.ps.set_prefetch_depth(int(prefetch_depth))
        for u in old.values():
            u.ps.close()
        return {"units": sorted(self.units)}

    def do_construct_pending(self, units, ps_cfg, plans_by_table=None):
        """Phase 1 of the cross-process swap: build the next epoch's units
        while the current ones keep serving."""
        if self.pending is not None:
            for u in self.pending.values():
                u.ps.close()
        self.pending = self._build_units(units, ps_cfg, plans_by_table)
        return {"pending": sorted(self.pending)}

    def do_commit_pending(self, prefetch_depth=None):
        """Phase 2: atomically swap pending in, close the old units LAST
        (the worker-local leg of build-before-teardown)."""
        if self.pending is None:
            raise RuntimeError(f"worker {self.worker}: commit without a "
                               f"pending construct")
        old, self.units, self.pending = self.units, self.pending, None
        for u in self.units.values():
            if self.degraded:    # swap must come up in the published mode
                u.ps.set_degraded(True)
            if prefetch_depth is not None:
                u.ps.set_prefetch_depth(int(prefetch_depth))
        for u in old.values():
            u.ps.close()
        return {"units": sorted(self.units)}

    def do_abort_pending(self):
        if self.pending is not None:
            for u in self.pending.values():
                u.ps.close()
            self.pending = None
        return {"aborted": True}

    def _select(self, unit_ids):
        """The units a verb applies to: all of them (unit_ids None — the
        single-tenant/whole-worker case) or the listed subset (the pool's
        tenant scoping; unknown ids are skipped, not an error, so a
        raced detach stays benign)."""
        if unit_ids is None:
            return list(self.units.values())
        return [self.units[int(i)] for i in unit_ids
                if int(i) in self.units]

    def do_sleep(self, seconds):
        """Failure-injection aid: a synthetic straggler/hung worker (the
        transport-timeout tests drive `WorkerDeadError` through it)."""
        time.sleep(float(seconds))
        return {"slept": float(seconds)}

    def do_shutdown(self):
        for u in self.units.values():
            u.ps.close()
        if self.pending is not None:
            for u in self.pending.values():
                u.ps.close()
        self.units, self.pending = {}, None
        return {"worker": self.worker, "stopped": True}

    # -- data path ----------------------------------------------------------
    def do_lookup(self, work, fused=False, combine="sum"):
        """Serve this worker's slice of one batch.

        `work`: per-unit dicts {unit_id, idx [b, t_u, L], weights|None,
        valid|None}. Units run serially (each PS keeps its single-caller
        contract). Replica units are timed — service seconds over served
        rows feed the pool-side `ReplicaRouter`. Returns per-unit raw row
        blocks ([b, t_u, L, D]) or fused pooled blocks ([b, t_u, D]), and
        the verb's own seconds (`seconds`: the worker's time, without the
        frames' travel)."""
        t_verb = time.perf_counter()
        out = []
        for item in work:
            u = self.units[int(item["unit_id"])]
            idx = item["idx"]
            if item.get("valid") is not None:
                u.ps.hint_valid(int(item["valid"]))
            timed = u.chunk is not None
            t0 = time.perf_counter() if timed else 0.0
            if fused:
                block = host_array(u.ps.lookup_fused(
                    idx, item.get("weights"), combine=combine))[0]
            else:
                block = u.ps.lookup(idx)
            service = time.perf_counter() - t0 if timed else 0.0
            out.append({"unit_id": u.unit_id, "block": block,
                        "service_s": service,
                        "served": int(idx.shape[0]) if timed else 0})
        return {"results": out, "seconds": time.perf_counter() - t_verb}

    def do_stage(self, work):
        ok = True
        for item in work:
            u = self.units[int(item["unit_id"])]
            ok &= bool(u.ps.stage(item["idx"]))
        return {"ok": ok}

    def do_can_stage(self, unit_ids=None):
        return {"ok": all(u.ps.can_stage()
                          for u in self._select(unit_ids))}

    # -- refresh ------------------------------------------------------------
    def do_plan_refresh(self, unit_ids=None):
        """Per-unit hot-set re-planning from each PS's own live window
        (worker-side planning: the window never crosses the pipe)."""
        return {"plans": {u.unit_id: u.ps.plan_refresh()
                          for u in self._select(unit_ids)}}

    def do_install_refresh(self, plans, unit_ids=None):
        results = [u.ps.install_refresh(plans.get(u.unit_id))
                   for u in self._select(unit_ids)]
        return {"replanned": any(r["replanned"] for r in results),
                "refreshes": max((r["refreshes"] for r in results),
                                 default=0)}

    # -- degraded / tuning --------------------------------------------------
    def do_set_degraded(self, on, unit_ids=None):
        if unit_ids is None:      # worker-level flag tracks whole-worker
            self.degraded = bool(on)     # toggles only, not tenant slices
        for u in self._select(unit_ids):
            u.ps.set_degraded(on)
        return {"degraded": self.degraded}

    def do_set_prefetch_depth(self, depth, unit_ids=None):
        sel = self._select(unit_ids)
        for u in sel:
            u.ps.set_prefetch_depth(int(depth))
        return {"depth": max((u.ps.prefetch.depth for u in sel),
                             default=0)}

    def do_prefetch_depth(self, unit_ids=None):
        return {"depth": max((u.ps.prefetch.depth
                              for u in self._select(unit_ids)),
                             default=0)}

    def do_take_window_peak(self, unit_ids=None):
        return {"peak": max((u.ps.prefetch.take_window_peak()
                             for u in self._select(unit_ids)),
                            default=0)}

    def do_retune(self, shares):
        """Per-unit budget shares (pool-computed, by table count)."""
        results = {}
        for uid, share in shares.items():
            u = self.units.get(int(uid))
            if u is not None:
                results[int(uid)] = u.ps.retune(int(share))
        return {"results": results}

    def do_flush(self, unit_ids=None):
        for u in self._select(unit_ids):
            u.ps.flush()
        return {"flushed": True}

    def do_flush_prefetch(self, unit_ids):
        """Targeted staged-batch flush (a routing move invalidated these
        units' staged slices; others keep theirs)."""
        for uid in unit_ids:
            u = self.units.get(int(uid))
            if u is not None:
                u.ps.prefetch.flush()
        return {"flushed": sorted(int(u) for u in unit_ids)}

    # -- online model updates ------------------------------------------------
    def do_apply_update(self, version, tables):
        """Phase 1 of the pool's distributed commit: buffer + validate the
        update rows for this worker's tables WITHOUT touching any tier —
        the worker can still die (or the pool can abort) and the committed
        version keeps serving untouched."""
        if self.tables is None:
            raise RuntimeError(f"worker {self.worker}: attach_tables must "
                               f"run before apply_update")
        T, R, _ = self.tables.shape
        buffered = {}
        total = 0
        for t, (rows, vals) in tables.items():
            t = int(t)
            if not 0 <= t < T:
                raise ValueError(f"update table {t} out of range [0, {T})")
            rows = np.asarray(rows, np.int64).ravel()
            if rows.size and (rows.min() < 0 or rows.max() >= R):
                raise ValueError(f"update rows for table {t} out of "
                                 f"range [0, {R})")
            vals, _ = host_array(vals)
            if vals.dtype != self.tables.dtype:
                raise ValueError(
                    f"update dtype {vals.dtype} != table dtype "
                    f"{self.tables.dtype}")
            buffered[t] = (rows, vals)
            total += int(rows.size)
        self.pending_update = (int(version), buffered)
        return {"buffered": total}

    def do_commit_update(self, version):
        """Phase 2: the pool already wrote the new bytes into the shared
        segment; fix every unit's caches over them. Zero-copy view units
        see the new cold rows through the segment (write_cold=False —
        only caches and the norm cache need maintenance); private-gather
        units write their own cold copy. A RESPAWNED worker arrives here
        with no pending buffer and returns a no-op — its units were
        rebuilt from the already-updated segment, so it is consistent by
        construction."""
        if self.pending_update is None:
            return {"applied": 0, "units": 0, "respawned": True}
        pv, buffered = self.pending_update
        if pv != int(version):
            raise RuntimeError(
                f"worker {self.worker}: commit_update(v{version}) does "
                f"not match the buffered update (v{pv})")
        applied = units = 0
        for u in self.units.values():
            local = {}
            for li, t in enumerate(u.table_ids):
                if int(t) in buffered:
                    local[li] = buffered[int(t)]
            if not local:
                continue
            write_cold = bool(u.ps.cold.tables.flags.writeable)
            applied += u.ps._install_update_rows(local,
                                                 write_cold=write_cold)
            units += 1
        self.pending_update = None
        return {"applied": applied, "units": units}

    def do_abort_update(self):
        had = self.pending_update is not None
        self.pending_update = None
        return {"aborted": had}

    # -- stats --------------------------------------------------------------
    @staticmethod
    def _device_bytes(ps) -> int:
        """Device-resident cache footprint of one unit's PS: hot block +
        warm payload rows (cold rows are host-side and excluded)."""
        return int((ps.num_hot + ps.cfg.warm_slots)
                   * ps.cold.num_tables * ps.cold.dim
                   * ps.cold.tables.dtype.itemsize)

    def do_stats(self, unit_ids=None):
        sel = self._select(unit_ids)
        return {
            "units": {u.unit_id: {"shard": u.shard, "stats": u.ps.stats(),
                                  "device_bytes": self._device_bytes(u.ps)}
                      for u in sel},
            "host_tier_bytes": sum(u.host_bytes for u in sel),
            "private_tier_bytes": sum(u.private_bytes for u in sel),
        }

    def do_reset_stats(self, unit_ids=None):
        for u in self._select(unit_ids):
            u.ps.reset_stats()
        return {"reset": True}

    def cleanup(self):
        self.do_shutdown()
        if self.segment is not None:
            self.tables = None
            try:
                self.segment.close()
            except BufferError:
                pass                # a live view outlived us; exit anyway
            self.segment = None


def worker_main(worker: int, conn) -> None:
    """Worker process entry: decode → dispatch → encode, until shutdown or
    pipe loss (parent died). Never unlinks the shared table segment — the
    pool created it and reclaims it."""
    # the unit views of the read-only shared segment are wrapped without
    # a copy; torch warns that it cannot mark such a tensor read-only
    warnings.filterwarnings("ignore", message="The given NumPy array is "
                            "not writable")
    state = _WorkerState(worker)
    try:
        while True:
            try:
                seq, verb, payload = conn.recv()
            except (EOFError, OSError):
                break
            try:
                handler = getattr(state, f"do_{verb}", None)
                if handler is None:
                    raise ValueError(f"unknown verb {verb!r}")
                kwargs = decode_payload(payload) or {}
                result = handler(**kwargs)
                status = "ok"
            except BaseException as e:
                status = "err"
                result = {"type": type(e).__name__, "msg": str(e),
                          "traceback": traceback.format_exc()}
            segments: list = []
            try:
                conn.send((seq, status, encode_payload(result, segments)))
            except (BrokenPipeError, OSError):
                break
            release_segments(segments)
            if verb == "shutdown" and status == "ok":
                break
    finally:
        state.cleanup()
        try:
            conn.close()
        except OSError:
            pass
