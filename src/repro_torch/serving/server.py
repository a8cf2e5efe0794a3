"""DLRM inference serving loop (paper §II-A deployment shape).

Queries arrive, a batcher groups them (the paper uses large batches of 2048
to saturate the GPU; same logic here), the engine executes the forward pass,
and per-query latencies are tracked against an SLA target. Percentile
reporting mirrors how the paper reports batch latency.

Prefer the `repro_torch.serving.session.ServingSession` facade, which wires
the forward engine, warmup, and storage lifecycle around this loop.

The engine returns scores as a tensor, which may lie on the card; the loop
copies them to the host itself (`.cpu().numpy()`), and that copy is the
point where the batch's device work is waited for.

With a storage backend bound, the loop also stages the NEXT batch's cache
misses before executing the current one (prefetch overlap) and re-plans
the hot set every `refresh_every_batches` batches, on a helper thread when
`async_refresh=True` — all through the protocol verbs.

`clock=` puts the loop on trace time: a replay harness passes a
`repro_torch.traffic.VirtualClock`, each executed batch advances it by the
batch's real service seconds, and query latency is virtual queueing plus
real service.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class Query:
    qid: int
    dense: np.ndarray          # [F]
    indices: np.ndarray        # [T, L]
    # None = stamped by the batcher at submit time (live traffic); replay
    # drivers preset the trace's nominal arrival so latency accounting
    # reflects offered load even when the server is behind
    arrival_s: Optional[float] = None


@dataclasses.dataclass
class BatcherConfig:
    max_batch: int = 2048
    max_wait_s: float = 0.002   # SLA-driven batching window
    pad_to_max: bool = True     # stable shapes => no recompilation
    # admission control (overload shedding); both default OFF so steady
    # state is untouched:
    # hard bound on queued queries — submit() sheds (typed rejection)
    # instead of letting arrivals outpace service without backpressure
    max_queue: int = 0          # 0 = unbounded
    # per-query deadline budget: shed at submit when the predicted wait
    # (queued batches ahead x EWMA batch service time) already blows it
    deadline_ms: float = 0.0    # 0 = off


class QueryShedError(RuntimeError):
    """Typed admission rejection — a shed query is never silently dropped.

    Raised by `Batcher.submit` when admission control rejects a query;
    carries enough context for the caller to retry elsewhere or count the
    loss. `reason` is `"queue_full"` (max_queue bound) or `"deadline"`
    (predicted wait exceeds the deadline budget)."""

    def __init__(self, qid: int, reason: str, queue_len: int,
                 predicted_wait_s: Optional[float] = None):
        self.qid = qid
        self.reason = reason
        self.queue_len = queue_len
        self.predicted_wait_s = predicted_wait_s
        wait = ("" if predicted_wait_s is None
                else f", predicted wait {predicted_wait_s * 1e3:.1f}ms")
        super().__init__(f"query {qid} shed ({reason}; "
                         f"queue_len={queue_len}{wait})")


class Batcher:
    """Groups queries into batches; owns the admission-control decision.

    `clock` abstracts time for the batching window and arrival stamps —
    the default is the real `time.perf_counter`; replay harnesses pass a
    virtual clock so offered load is deterministic.
    """

    #: EWMA smoothing for the observed batch service time (deadline
    #: admission). One observation per executed batch; 0.3 tracks load
    #: shifts within a few batches without chasing single-batch noise.
    SERVICE_EWMA_ALPHA = 0.3

    def __init__(self, cfg: BatcherConfig, clock: Optional[Callable] = None):
        self.cfg = cfg
        self.clock = clock if clock is not None else time.perf_counter
        self.queue: collections.deque[Query] = collections.deque()
        self.shed = 0
        self.shed_reasons: collections.Counter = collections.Counter()
        self.service_ewma_s: Optional[float] = None

    def observe_service(self, dt_s: float) -> None:
        """One executed batch took `dt_s` seconds — feed the service-time
        EWMA the deadline admission predicts waits from."""
        a = self.SERVICE_EWMA_ALPHA
        self.service_ewma_s = (dt_s if self.service_ewma_s is None
                               else a * dt_s + (1 - a) * self.service_ewma_s)

    def _admit(self, q: Query) -> None:
        """Shed (raise) instead of queueing when admission control says the
        query cannot be served usefully: the queue bound is hit, or the
        predicted wait to its batch's completion already exceeds the
        deadline budget. Runs BEFORE the query is queued, so a shed query
        costs no assembly or service work at all."""
        cfg = self.cfg
        qlen = len(self.queue)
        if cfg.max_queue and qlen >= cfg.max_queue:
            self.shed += 1
            self.shed_reasons["queue_full"] += 1
            raise QueryShedError(q.qid, "queue_full", qlen)
        if cfg.deadline_ms and self.service_ewma_s is not None:
            # whole batches queued AHEAD of this query. Its own batch's
            # service deliberately doesn't count: an empty queue must
            # always admit, or one slow batch (compile, GC) could push the
            # EWMA past the deadline and wedge admission shut forever —
            # nothing served means the estimate never refreshes
            batches_ahead = qlen // cfg.max_batch
            wait = batches_ahead * self.service_ewma_s
            if wait > cfg.deadline_ms / 1e3:
                self.shed += 1
                self.shed_reasons["deadline"] += 1
                raise QueryShedError(q.qid, "deadline", qlen, wait)

    def submit(self, q: Query) -> None:
        self._admit(q)
        if q.arrival_s is None:
            q.arrival_s = self.clock()
        self.queue.append(q)

    def next_batch(self, force: bool = False) -> Optional[list[Query]]:
        """A full batch, or a partial one once the head query's batching
        window has elapsed. `force=True` flushes a partial batch
        immediately (drain/shutdown path)."""
        if not self.queue:
            return None
        deadline = self.queue[0].arrival_s + self.cfg.max_wait_s
        if (not force and len(self.queue) < self.cfg.max_batch
                and self.clock() < deadline):
            return None
        out = []
        while self.queue and len(out) < self.cfg.max_batch:
            out.append(self.queue.popleft())
        return out


@dataclasses.dataclass
class ServeStats:
    served: int = 0
    batch_latencies_s: list = dataclasses.field(default_factory=list)
    query_latencies_s: list = dataclasses.field(default_factory=list)
    # refreshes whose planning phase ran on the helper thread
    async_refreshes: int = 0
    # admission control: queries shed at submit (typed rejections, by
    # reason) and the request-queue length gauge, mirrored from the
    # batcher after every submit/poll
    shed_queries: int = 0
    shed_reasons: dict = dataclasses.field(default_factory=dict)
    request_queue_len: int = 0
    # the storage backend's stats() — for `tiered` the hot/warm hit rates,
    # cold misses, evictions, refreshes, the prefetch queue and overlap
    # counters and the degraded-mode counters — mirrored after every
    # executed batch and reported by percentiles(). Empty for `device`.
    storage_stats: dict = dataclasses.field(default_factory=dict)

    def percentiles(self) -> dict:
        """Latency percentiles, admission gauges and the backend's stats.
        `off_critical_frac` (tiered) is the fraction of cold-missed rows
        whose host gather never ran on the lookup critical path."""
        if not self.query_latencies_s:
            return {}
        q = np.asarray(self.query_latencies_s) * 1e3
        b = np.asarray(self.batch_latencies_s) * 1e3
        out = {"p50_ms": float(np.percentile(q, 50)),
               "p95_ms": float(np.percentile(q, 95)),
               "p99_ms": float(np.percentile(q, 99)),
               "mean_batch_ms": float(b.mean()),
               "served": self.served}
        # admission gauges ride along unconditionally: an operator reading
        # shed_queries == 0 learns shedding is armed-but-idle, which a
        # missing key cannot say
        out["shed_queries"] = self.shed_queries
        out["request_queue_len"] = self.request_queue_len
        out.update(self.storage_stats)
        if self.async_refreshes:
            out["async_refreshes"] = self.async_refreshes
        return out


class InferenceServer:
    """forward(dense [B,F], indices [B,T,L]) -> scores [B] (a tensor).

    Pass the model's storage backend as `storage` (any
    `repro_torch.storage.EmbeddingStorage`): the server then (a) stages the
    NEXT pending batch's cache misses before executing the current one
    (prefetch overlap), (b) re-plans the hot set every
    `refresh_every_batches` executed batches from the backend's sliding
    traffic window (paper §IV-C periodic re-pinning) — on a helper thread
    when `async_refresh=True` — and (c) mirrors the backend's counters into
    `stats.percentiles()`. All of it goes through the protocol verbs, so
    backends that cannot stage or refresh degrade to no-ops.
    """

    def __init__(self, forward: Callable, batcher_cfg: BatcherConfig,
                 sla_ms: float = 50.0, storage=None,
                 refresh_every_batches: int = 0,
                 async_refresh: bool = False,
                 clock: Optional[Callable] = None):
        self.forward = forward
        # `clock` abstracts serving time: None = real time.perf_counter;
        # a replay harness passes a `repro_torch.traffic.VirtualClock`
        # (callable with an `advance()` method) so latencies are measured
        # in trace time — real batch service durations advance it
        self.clock = clock if clock is not None else time.perf_counter
        self._clock_advance = getattr(clock, "advance", None)
        self.batcher = Batcher(batcher_cfg, clock=self.clock)
        self.sla_s = sla_ms / 1e3
        self.stats = ServeStats()
        self.storage = storage
        if (async_refresh and storage is not None
                and not storage.capabilities().refreshable):
            from repro_torch.storage import require_capability
            require_capability(storage, "refreshable")
        self.refresh_every_batches = refresh_every_batches
        self.async_refresh = async_refresh
        self._executed_batches = 0
        self._refresh_pool: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self._refresh_future: Optional[concurrent.futures.Future] = None
        # optional response tap: called with (batch, scores[:len(batch)])
        # after every executed batch, outside the timed region
        self.on_batch: Optional[Callable] = None

    def submit(self, q: Query) -> None:
        """Admit or shed one query. A shed query raises `QueryShedError`
        (typed, never silent); either way the admission gauges mirror into
        stats so `percentiles()` reflects sheds that happened between
        polls."""
        try:
            self.batcher.submit(q)
        finally:
            self.stats.shed_queries = self.batcher.shed
            self.stats.shed_reasons = dict(self.batcher.shed_reasons)
            self.stats.request_queue_len = len(self.batcher.queue)

    @staticmethod
    def _assemble_indices(batch: list[Query], b: int) -> np.ndarray:
        """[b, T, L] int32 index tensor; rows past len(batch) stay zero
        (the padding hint_valid() later excludes from backend stats).
        Shared by _assemble and _stage_next so staged indices always match
        the upcoming lookup's bit for bit (consume() matches on
        equality)."""
        idx = np.zeros((b,) + batch[0].indices.shape, np.int32)
        for i, q in enumerate(batch):
            idx[i] = q.indices
        return idx

    def _assemble(self, batch: list[Query]):
        """dense [b, F] float32 and indices [b, T, L] int32; rows past
        len(batch) stay zero (batcher padding)."""
        cfg = self.batcher.cfg
        b = cfg.max_batch if cfg.pad_to_max else len(batch)
        dense = np.zeros((b,) + batch[0].dense.shape, np.float32)
        for i, q in enumerate(batch):
            dense[i] = q.dense
        return dense, self._assemble_indices(batch, b)

    def _stage_next(self) -> None:
        """Prefetch: resolve the next FULL pending batch's cold misses now,
        so its host gathers overlap the current batch's compute. Only a
        full batch is staged — its contents are then FIFO-deterministic, so
        the staged indices exactly match the upcoming lookup. Backpressure
        is checked before any assembly work, and only the indices are
        assembled (staging never needs the dense features)."""
        q = self.batcher.queue
        b = self.batcher.cfg.max_batch
        if len(q) < b or not self.storage.can_stage():
            return
        nxt = list(itertools.islice(q, b))
        self.storage.stage(self._assemble_indices(nxt, b))

    # -- async refresh driver -----------------------------------------------
    def _start_refresh(self) -> None:
        """Kick off re-pinning. Sync mode blocks here; async mode snapshots
        the traffic window on this thread and plans on a helper, leaving
        installation to a later poll()."""
        if not self.async_refresh:
            self.storage.refresh()
            return
        if self._refresh_future is not None:    # previous plan still in
            return                              # flight: don't pile up
        if self._refresh_pool is None:
            self._refresh_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ps-refresh")
        window = self.storage.refresh_window()  # snapshot on serving thread
        self._refresh_future = self._refresh_pool.submit(
            self.storage.plan_refresh, window)

    def _install_refresh_if_ready(self) -> None:
        """Install a finished helper-thread plan (serving thread only —
        install_refresh mutates tier state). Planner exceptions re-raise
        here, on the serving thread."""
        if self._refresh_future is not None and self._refresh_future.done():
            self._install_pending_refresh()

    def _install_pending_refresh(self) -> None:
        """Take the in-flight future (blocking if unfinished), install its
        plan — a None plan still applies the scheduled warm-tier decay,
        exactly like a sync refresh — count a real re-pin, and re-mirror
        the backend's stats. Shared by the poll() path and close()."""
        fut, self._refresh_future = self._refresh_future, None
        if self.storage.install_refresh(fut.result())["replanned"]:
            self.stats.async_refreshes += 1
        self.stats.storage_stats = self.storage.stats()

    def poll(self, force: bool = False) -> int:
        """Execute at most one batch; returns #queries served."""
        batch = self.batcher.next_batch(force=force)
        if not batch:
            return 0
        n = len(batch)
        dense, idx = self._assemble(batch)
        if self.storage is not None:
            # both run outside the timed region. Install a finished
            # refresh FIRST so staging probes the post-refresh tier state
            # (staging against the old plan would prefetch rows about to
            # become hot and skip warm rows about to be invalidated).
            self._install_refresh_if_ready()
            # staging models work that overlaps the PREVIOUS batch's
            # compute, so it must not bill this batch
            self._stage_next()
            # batcher padding is not traffic — keep it out of cache stats
            # and the refresh window
            self.storage.hint_valid(n)
        t0 = time.perf_counter()
        # the copy to the host waits for the batch's device work
        scores = self.forward(dense, idx).cpu().numpy()
        t1 = time.perf_counter()
        if self.on_batch is not None:
            self.on_batch(batch, scores[:n])
        # batch service time is always REAL seconds (it feeds the deadline
        # admission's EWMA), and it ends once the scores are on the host;
        # a virtual clock advances by exactly that duration, so query
        # latencies = virtual queueing delay + real service
        service = t1 - t0
        self.batcher.observe_service(service)
        if self._clock_advance is not None:
            self._clock_advance(service)
            done = self.clock()
        else:
            done = t1
        self.stats.batch_latencies_s.append(service)
        for q in batch:
            self.stats.query_latencies_s.append(done - q.arrival_s)
        self.stats.served += n
        self.stats.request_queue_len = len(self.batcher.queue)
        if self.storage is not None:
            self._executed_batches += 1
            if (self.refresh_every_batches
                    and self._executed_batches
                    % self.refresh_every_batches == 0):
                self._start_refresh()
            self.stats.storage_stats = self.storage.stats()
        return n

    def drain(self, timeout_s: float = 10.0, poll=None) -> None:
        """Serve until the queue empties. Honours the batching window while
        it is open, but force-flushes the partial batch once the head
        query's deadline — or this call's own timeout — is reached, so a
        sub-`max_batch` remainder can never starve (busy-spin bug).
        `poll` substitutes a wrapped poll (the session passes its
        controller-aware one) so the force-flush law lives only here."""
        poll = self.poll if poll is None else poll
        t0 = time.perf_counter()
        while self.batcher.queue:
            now = self.clock()
            head_deadline = (self.batcher.queue[0].arrival_s
                             + self.batcher.cfg.max_wait_s)
            force = (now >= head_deadline
                     or time.perf_counter() - t0 >= timeout_s)
            served = poll(force=force)
            if (not served and not force
                    and self._clock_advance is not None):
                # a virtual clock only moves when a batch executes, so a
                # partial batch inside its batching window would spin here
                # forever — model the wait by advancing to the deadline
                self._clock_advance(max(0.0, head_deadline - self.clock()))

    def close(self) -> None:
        """Finish any in-flight async refresh — wait for the planner,
        install its plan, and re-mirror the backend's stats so the final
        report sees it — then stop the helper thread. Planner exceptions
        re-raise here, matching the poll() path. Does NOT close the
        storage backend. Idempotent."""
        try:
            if self._refresh_future is not None:
                self._install_pending_refresh()
        finally:
            # a raising planner must not leak the helper pool/thread
            if self._refresh_pool is not None:
                self._refresh_pool.shutdown(wait=True)
                self._refresh_pool = None

    def sla_violations(self) -> int:
        return int(np.sum(np.asarray(self.stats.query_latencies_s)
                          > self.sla_s))
