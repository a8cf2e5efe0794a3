"""Prefetch staging — the paper's software prefetching across the hierarchy.

The GPU kernel prefetches rows `distance` iterations ahead so the gather
latency overlaps compute (§IV-B). At the parameter-server level the same
idea applies one level up: while batch N computes, batch N+1's indices are
already known (they sit in the batcher queue), so their warm-tier misses can
be resolved against the host cold store ahead of time.

Two staging engines share one contract:

  `PrefetchQueue`    — synchronous. `stage()` resolves the future batch's
                       cold payloads immediately on the caller thread and
                       parks them; `consume()` hands them back when the
                       batch is looked up. This models overlap (the gathers
                       happen before the batch's timed region) but the
                       gather work still runs on the serving thread.
  `AsyncPrefetcher`  — threaded. `stage()` snapshots the miss rows and
                       returns; a background worker resolves the cold
                       gathers into the staged buffer while the current
                       batch computes. The queue is the double buffer: with
                       `depth=2` one buffer is being filled by the worker
                       while the other is being drained by `consume()`.

Buffer-ownership rules (AsyncPrefetcher)
----------------------------------------
A staged buffer (`_Job.batch`) passes through three states:

  PENDING — owned by whoever holds the queue lock. The caller thread wrote
            `batch.rows` before enqueue and nobody touches `batch.data`.
  RUNNING — owned by the worker thread, exclusively. Only the worker writes
            `batch.data`. `consume()` finding a RUNNING job must wait on
            `job.ready` before reading any payload.
  READY   — ownership transferred back to the consumer (`job.ready` is
            set). The worker never touches the buffer again; `consume()`
            may read `batch.data` freely.

A `consume()` that finds the matching job still PENDING claims it under the
lock and resolves it inline on the caller thread (the prefetch lost the
race; counted in `consume_waited`). `flush()` marks in-flight jobs
cancelled: the worker drops a cancelled PENDING job without resolving it,
and a cancelled RUNNING job resolves into an orphaned buffer that no one
will ever read. Worker exceptions are captured and re-raised exactly once,
on the caller thread, by the next `stage()` call; a failed staged buffer is
silently discarded at `consume()` (the lookup falls back to a direct cold
gather), so a prefetch failure can degrade overlap but never a lookup.

The warm cache may have changed between stage and consume (earlier batches
admit rows), so staged data is keyed by row id and the server only uses it
for rows that still miss — any residual misses fall through to a direct
cold gather. Correctness never depends on staging; it only moves gather
work earlier (sync) or off the critical path entirely (async).

A copy of `repro/ps/prefetch.py` (numpy and threads only).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

import numpy as np

# resolver(table, rows [M]) -> payload [M, D]; typically ColdStore.gather
Resolver = Callable[[int, np.ndarray], np.ndarray]

_PENDING, _RUNNING, _READY = 0, 1, 2


@dataclasses.dataclass
class StagedBatch:
    indices: np.ndarray                  # [B, T, L] raw row ids
    rows: dict[int, np.ndarray]          # table -> distinct staged row ids
    data: dict[int, np.ndarray]          # table -> staged payload [M, D]
    # True when the payload was already resolved when consume() returned it
    # (i.e. the gather ran fully off the consumer's critical path).
    ready_at_consume: bool = True


class _PrefetchBase:
    """Counters + the staged/missed partition shared by both engines."""

    def __init__(self, depth: int):
        self.depth = int(depth)
        self.staged_rows = 0
        self.prefetch_hits = 0       # missed rows served from staged data
        self.prefetch_misses = 0     # missed rows needing a late cold gather
        self.off_critical_rows = 0   # staged hits whose gather never touched
        #                              the consumer's critical path
        self.max_queue_depth = 0
        self._win_peak = 0           # peak since take_window_peak()

    # -- subclass contract --------------------------------------------------
    def __len__(self) -> int:                            # staged batches
        raise NotImplementedError

    def can_stage(self) -> bool:
        """Backpressure probe: False when the queue is full (or disabled).
        Callers use it to skip the miss-probing work entirely."""
        return self.depth > 0 and len(self) < self.depth

    def stage(self, batch: StagedBatch) -> bool:
        raise NotImplementedError

    def set_depth(self, depth: int) -> None:
        """Move the bounded-buffer depth at runtime (the queue-depth
        auto-tuner's knob). Shrinking below the current queue length never
        drops staged batches — `can_stage()` simply stays False until the
        queue drains under the new bound. Depth 0 disables staging."""
        self.depth = max(0, int(depth))

    def take_window_peak(self) -> int:
        """Peak queue occupancy since the previous call — the auto-tuner's
        per-window observation (cumulative `max_queue_depth` never resets,
        so it cannot tell whether the CURRENT bound was recently needed).
        Resets the window to the present occupancy."""
        peak, self._win_peak = self._win_peak, len(self)
        return peak

    def consume(self, indices: np.ndarray) -> StagedBatch | None:
        raise NotImplementedError

    def flush(self) -> None:
        """Drop every staged batch (counters untouched)."""
        raise NotImplementedError

    def close(self) -> None:
        """Release resources (worker thread, if any). Idempotent."""

    # -- shared logic -------------------------------------------------------
    def split_misses(self, staged: StagedBatch | None, table: int,
                     miss_rows: np.ndarray):
        """Partition missed rows into (staged payload, residual row ids).

        Returns (rows_hit, data_hit, rows_residual) with staged-hit payloads
        already gathered at stage/worker time. `miss_rows` must be sorted
        ascending (np.unique output), as must `staged.rows[table]`.
        """
        if staged is None or table not in staged.rows or miss_rows.size == 0:
            self.prefetch_misses += int(miss_rows.size)
            return (np.empty(0, np.int64),
                    np.empty((0, 0), np.float32), miss_rows)
        srows = staged.rows[table]
        pos = np.searchsorted(srows, miss_rows)
        pos = np.minimum(pos, len(srows) - 1)
        hit = srows[pos] == miss_rows
        n_hit = int(hit.sum())
        self.prefetch_hits += n_hit
        self.prefetch_misses += int((~hit).sum())
        if staged.ready_at_consume:
            self.off_critical_rows += n_hit
        return (miss_rows[hit], staged.data[table][pos[hit]],
                miss_rows[~hit])

    def stats(self) -> dict:
        resolved = self.prefetch_hits + self.prefetch_misses
        return {"staged_rows": self.staged_rows,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_misses": self.prefetch_misses,
                "queue_depth": len(self),
                "max_queue_depth": self.max_queue_depth,
                "off_critical_rows": self.off_critical_rows,
                "off_critical_frac": (self.off_critical_rows / resolved
                                      if resolved else 0.0)}

    def reset(self) -> None:
        self.staged_rows = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.off_critical_rows = 0
        self.max_queue_depth = len(self)
        self._win_peak = len(self)


class PrefetchQueue(_PrefetchBase):
    """Synchronous staging: payloads resolve at `stage()` time.

    With `resolver` set, `stage()` fills any unresolved `batch.rows` entry
    by calling it on the caller thread; without one, the caller must hand
    over fully-resolved batches (legacy contract, kept for direct users of
    `split_misses`).
    """

    def __init__(self, depth: int, resolver: Resolver | None = None):
        super().__init__(depth)
        self.resolver = resolver
        self.queue: collections.deque[StagedBatch] = collections.deque()

    def __len__(self) -> int:
        return len(self.queue)

    def stage(self, batch: StagedBatch) -> bool:
        """Enqueue a future batch; False when the queue is full. Resolves
        missing payloads inline (synchronous gather)."""
        if not self.can_stage():
            return False
        if self.resolver is not None:
            for t, rows in batch.rows.items():
                if t not in batch.data:
                    batch.data[t] = self.resolver(t, rows)
        self.staged_rows += sum(int(r.size) for r in batch.rows.values())
        self.queue.append(batch)
        self.max_queue_depth = max(self.max_queue_depth, len(self.queue))
        self._win_peak = max(self._win_peak, len(self.queue))
        return True

    def consume(self, indices: np.ndarray) -> StagedBatch | None:
        """Pop the staged batch matching `indices` (FIFO scan), if any."""
        for i, st in enumerate(self.queue):
            if st.indices.shape == indices.shape and \
                    np.array_equal(st.indices, indices):
                del self.queue[i]
                return st
        return None

    def flush(self) -> None:
        self.queue.clear()


@dataclasses.dataclass(eq=False)
class _Job:
    """One double-buffer slot; see the module docstring for ownership.

    `eq=False`: jobs are identity objects. A generated `__eq__` would compare
    `StagedBatch` ndarray fields, and `deque.remove()` in `consume()` then
    broadcasts differently-shaped queued batches against each other (e.g.
    after the SLO ladder shrinks the batch size mid-stream)."""
    batch: StagedBatch
    ready: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    state: int = _PENDING
    cancelled: bool = False
    error: BaseException | None = None


class AsyncPrefetcher(_PrefetchBase):
    """Threaded staging: a worker resolves cold gathers off the critical path.

    `stage()` is O(enqueue): the caller has already probed hot+warm and
    recorded the miss rows; the worker performs the cold-store gathers into
    the staged buffer while the consumer computes the current batch. The
    bounded queue (`depth`, default 2 = classic double buffering) provides
    backpressure: `stage()` returns False instead of blocking or growing
    without bound.
    """

    def __init__(self, depth: int, resolver: Resolver):
        super().__init__(depth)
        self.resolver = resolver
        self._cv = threading.Condition()
        self._jobs: collections.deque[_Job] = collections.deque()
        self._pending: collections.deque[_Job] = collections.deque()
        self._error: BaseException | None = None
        self._closed = False
        # async-specific counters
        self.consume_ready = 0       # buffer READY when consumed: full overlap
        self.consume_waited = 0      # consumer waited / resolved inline
        self.wait_s = 0.0            # total time the consumer spent blocked
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ps-async-prefetch")
        self._thread.start()

    # -- worker -------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                job = self._pending.popleft()
                job.state = _RUNNING
            self._resolve(job)

    def _resolve(self, job: _Job) -> None:
        try:
            if not job.cancelled:
                for t, rows in job.batch.rows.items():
                    job.batch.data[t] = self.resolver(t, rows)
        except BaseException as e:                 # propagate to the caller
            job.error = e
            with self._cv:
                self._error = e
        finally:
            job.state = _READY
            job.ready.set()

    def _raise_pending_error(self) -> None:
        with self._cv:                 # the worker writes _error under _cv
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async prefetch worker failed") from err

    # -- caller-thread API --------------------------------------------------
    def __len__(self) -> int:
        return len(self._jobs)

    def can_stage(self) -> bool:
        """False once closed, so the can_stage-then-stage pattern (the
        serving driver's backpressure guard) degrades to skipping staging
        instead of raising after a torn-down parameter server."""
        return not self._closed and super().can_stage()

    def set_depth(self, depth: int) -> None:
        """Runtime depth change, taken under the queue lock (the worker
        reads `depth` only through `stage()`/`can_stage()` on the caller
        thread, but the lock keeps the bound coherent with the queue)."""
        with self._cv:
            self.depth = max(0, int(depth))

    def stage(self, batch: StagedBatch) -> bool:
        """Enqueue miss rows for background resolution; False when full."""
        self._raise_pending_error()
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncPrefetcher is closed")
            if self.depth == 0 or len(self._jobs) >= self.depth:
                return False
            job = _Job(batch)
            self._jobs.append(job)
            self._pending.append(job)
            self.staged_rows += sum(int(r.size)
                                    for r in batch.rows.values())
            self.max_queue_depth = max(self.max_queue_depth,
                                       len(self._jobs))
            self._win_peak = max(self._win_peak, len(self._jobs))
            self._cv.notify()
        return True

    def consume(self, indices: np.ndarray) -> StagedBatch | None:
        """Pop the staged batch matching `indices`, waiting for (or inline-
        resolving) its payload if the worker has not finished it yet.

        Never raises on a worker failure: a failed job is dequeued (so the
        error cannot pin a queue slot) and dropped, returning None — the
        caller's lookup then resolves those rows with a direct cold gather
        and stays correct. The failure itself surfaces once, on the next
        `stage()` call."""
        claimed_pending = False
        with self._cv:
            job = None
            for j in self._jobs:
                if j.batch.indices.shape == indices.shape and \
                        np.array_equal(j.batch.indices, indices):
                    job = j
                    break
            if job is not None:
                self._jobs.remove(job)
                if job.state == _PENDING:
                    # the worker has not picked it up: claim it and resolve
                    # on this thread (the prefetch lost the race entirely)
                    self._pending.remove(job)
                    job.state = _RUNNING
                    claimed_pending = True
        if job is None:
            return None
        if claimed_pending:
            t0 = time.perf_counter()
            self._resolve(job)
            self.wait_s += time.perf_counter() - t0
            self.consume_waited += 1
            job.batch.ready_at_consume = False
        elif job.ready.is_set():
            self.consume_ready += 1
            job.batch.ready_at_consume = True
        else:
            t0 = time.perf_counter()
            job.ready.wait()
            self.wait_s += time.perf_counter() - t0
            self.consume_waited += 1
            job.batch.ready_at_consume = False
        if job.error is not None:
            # degrade, don't fail the lookup: the caller re-gathers these
            # rows from the cold store; the error raises once, on the next
            # stage() (self._error is still set)
            return None
        return job.batch

    def flush(self) -> None:
        """Cancel and drop every staged batch. A RUNNING job resolves into
        an orphaned buffer that no consumer will ever read."""
        with self._cv:
            for job in self._jobs:
                job.cancelled = True
            self._jobs.clear()
            self._pending.clear()

    def close(self) -> None:
        """Stop the worker and join it. Idempotent; pending jobs are
        cancelled, not resolved. A captured worker error that no stage()
        ever reported raises here (after the thread is down) rather than
        being silently destroyed with the queue."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            for job in self._pending:
                job.cancelled = True
                job.ready.set()
            self._pending.clear()
            self._jobs.clear()
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        self._raise_pending_error()

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        s = super().stats()
        consumed = self.consume_ready + self.consume_waited
        s.update({"consume_ready": self.consume_ready,
                  "consume_waited": self.consume_waited,
                  "consume_wait_s": self.wait_s,
                  "consume_overlap_frac": (self.consume_ready / consumed
                                           if consumed else 0.0)})
        return s

    def reset(self) -> None:
        super().reset()
        self.consume_ready = 0
        self.consume_waited = 0
        self.wait_s = 0.0
