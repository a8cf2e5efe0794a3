"""Replay a timestamped query stream through a `ServingSession` on a
virtual clock.

The driver is a deterministic event loop over trace time:

  * before each arrival, the server gets to do everything it WOULD have
    done by then — full batches execute immediately, and a partial batch
    whose batching window closes before the arrival is flushed at its
    deadline (the clock jumps to the deadline first, exactly like a real
    server waking on its batching timer);
  * the clock then jumps to the arrival and the query is submitted —
    admission control may shed it (`QueryShedError`), which is counted,
    never silently dropped;
  * each executed batch advances the clock by its REAL measured service
    duration (see `serving.server.InferenceServer.poll`), so queueing
    delay is virtual/deterministic while service cost is honest.

After every poll a `ReplaySnapshot` lands on the timeline — windowed p99,
queue length, shed/degraded state against trace time — which is what the
overload tests and `chip_smoke.py`'s replay phases read.

`replay_tenants()` lifts the same event loop to a `TenantManager`'s N
queues on its one clock. A port of `repro/traffic/replay.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.server import Query, QueryShedError
from repro_torch.serving.slo import windowed_p99_ms


@dataclasses.dataclass(frozen=True)
class ReplaySnapshot:
    """Serving state right after one executed batch (trace time)."""
    t_s: float                      # virtual now
    served: int                     # cumulative queries served
    shed: int                       # cumulative queries shed
    queue_len: int                  # request queue length
    windowed_p99_ms: Optional[float]
    slo_level: int                  # 0 when no SLO controller is wired
    degraded: bool                  # storage in warm-cache-only mode


@dataclasses.dataclass
class ReplayReport:
    """What happened to one replayed stream."""
    submitted: int = 0              # queries offered by the trace
    admitted: int = 0               # queries accepted into the queue
    shed: int = 0                   # typed admission rejections
    served: int = 0                 # queries answered
    timeline: list = dataclasses.field(default_factory=list)
    percentiles: dict = dataclasses.field(default_factory=dict)

    @property
    def shed_frac(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    def snapshots_after(self, t_s: float) -> list:
        return [s for s in self.timeline if s.t_s >= t_s]

    def final_windowed_p99_ms(self) -> Optional[float]:
        return self.timeline[-1].windowed_p99_ms if self.timeline else None


def replay(session, queries, *, window_queries: int = 256,
           drain: bool = True) -> ReplayReport:
    """Drive `session` through `queries` (an iterable of
    `traffic.TimedQuery`, arrival-ordered) on its virtual clock.

    The session must have been built with `clock=VirtualClock()`; polls
    go through `session.poll` so the auto-tuner and SLO controller step
    exactly as they would under live traffic. With `drain=True` the queue
    is emptied after the last arrival (same deadline-jump rule), so the
    report's percentiles cover every admitted query.
    """
    clock = session.clock
    if clock is None or not hasattr(clock, "advance"):
        raise TypeError(
            "replay() needs a session on trace time — construct it with "
            "ServingSession(..., clock=repro_torch.traffic.VirtualClock())")
    batcher = session.server.batcher
    report = ReplayReport()

    def snap():
        stats = session.stats
        report.timeline.append(ReplaySnapshot(
            t_s=clock.now,
            served=stats.served,
            shed=stats.shed_queries,
            queue_len=len(batcher.queue),
            windowed_p99_ms=windowed_p99_ms(stats.query_latencies_s,
                                            window_queries),
            slo_level=0 if session.slo is None else session.slo.level,
            degraded=session.storage.degraded()))

    def poll_and_snap():
        if session.poll():
            snap()

    for q in queries:
        arrival = q.arrival_s
        # serve what the server finishes BEFORE this arrival: it is idle at
        # clock.now (each poll advances the clock to its batch's completion),
        # so it starts a full batch there, or flushes a partial batch when
        # its batching window closes first. Once clock.now passes the
        # arrival the server is busy through it — the query just queues,
        # which is exactly how an overload backlog builds.
        while batcher.queue and clock.now < arrival:
            # read max_batch live: the SLO shrink rung re-sizes the
            # batcher's cfg mid-replay
            if len(batcher.queue) >= batcher.cfg.max_batch:
                poll_and_snap()
                continue
            deadline = batcher.queue[0].arrival_s + batcher.cfg.max_wait_s
            if deadline >= arrival:
                break               # window still open at arrival time
            if clock.now < deadline:
                clock.advance(deadline - clock.now)
            poll_and_snap()
        if arrival > clock.now:
            clock.advance(arrival - clock.now)
        report.submitted += 1
        try:
            session.submit(Query(qid=q.qid, dense=q.dense,
                                 indices=q.indices, arrival_s=arrival))
            report.admitted += 1
        except QueryShedError:
            report.shed += 1

    if drain:
        while batcher.queue:
            if len(batcher.queue) < batcher.cfg.max_batch:
                deadline = (batcher.queue[0].arrival_s
                            + batcher.cfg.max_wait_s)
                if clock.now < deadline:
                    clock.advance(deadline - clock.now)
            poll_and_snap()

    report.served = session.stats.served
    report.percentiles = session.percentiles()
    return report


def replay_tenants(manager, streams: dict, *, window_queries: int = 256,
                   drain: bool = True) -> dict:
    """Drive a `serving.TenantManager` through per-tenant query streams
    merged on its ONE virtual clock; returns `{tenant: ReplayReport}`.

    Same event-loop law as `replay()`, lifted to N queues: before each
    (globally earliest) arrival the manager serves everything it would
    have by then — any full queue executes immediately, else the earliest
    batching-window deadline across tenants flushes first — and each
    executed batch advances the shared clock by its real service cost, so
    tenants genuinely contend for serving time. Which tenant a given poll
    executes is the manager's scheduling policy ('fair'/'fifo'), which is
    exactly what the noisy-neighbor benchmark legs compare.
    """
    clock = manager.clock
    if clock is None or not hasattr(clock, "advance"):
        raise TypeError(
            "replay_tenants() needs a manager on trace time — construct "
            "it with TenantManager(..., "
            "clock=repro_torch.traffic.VirtualClock())")
    unknown = set(streams) - set(manager.names)
    if unknown:
        raise KeyError(f"streams for unattached tenants: {sorted(unknown)}")
    reports = {n: ReplayReport() for n in streams}
    iters = {n: iter(s) for n, s in streams.items()}
    heads = {n: next(it, None) for n, it in iters.items()}

    def queues():
        return {n: manager.session(n).server.batcher
                for n in manager.names
                if manager.session(n).server.batcher.queue}

    def snap(name):
        sess = manager.session(name)
        stats = sess.stats
        reports.setdefault(name, ReplayReport()).timeline.append(
            ReplaySnapshot(
                t_s=clock.now,
                served=stats.served,
                shed=stats.shed_queries,
                queue_len=len(sess.server.batcher.queue),
                windowed_p99_ms=windowed_p99_ms(stats.query_latencies_s,
                                                window_queries),
                slo_level=0 if sess.slo is None else sess.slo.level,
                degraded=sess.storage.degraded()))

    def poll_and_snap(force=False):
        served = manager.poll(force=force)
        if served and manager.last_polled is not None:
            snap(manager.last_polled)
        return served

    while any(h is not None for h in heads.values()):
        name = min((n for n in heads if heads[n] is not None),
                   key=lambda n: heads[n].arrival_s)
        q = heads[name]
        arrival = q.arrival_s
        while clock.now < arrival:
            pending = queues()
            if not pending:
                break
            if any(len(b.queue) >= b.cfg.max_batch
                   for b in pending.values()):
                poll_and_snap()
                continue
            d = min(b.queue[0].arrival_s + b.cfg.max_wait_s
                    for b in pending.values())
            if d >= arrival:
                break               # every window still open at arrival
            if d > clock.now:
                clock.advance(d - clock.now)
            if not poll_and_snap():
                break               # guard: no progress despite a jump
        if arrival > clock.now:
            clock.advance(arrival - clock.now)
        reports[name].submitted += 1
        try:
            manager.submit(name, Query(qid=q.qid, dense=q.dense,
                                       indices=q.indices,
                                       arrival_s=arrival))
            reports[name].admitted += 1
        except QueryShedError:
            reports[name].shed += 1
        heads[name] = next(iters[name], None)

    if drain:
        while True:
            pending = queues()
            if not pending:
                break
            if not any(len(b.queue) >= b.cfg.max_batch
                       for b in pending.values()):
                d = min(b.queue[0].arrival_s + b.cfg.max_wait_s
                        for b in pending.values())
                if d > clock.now:
                    clock.advance(d - clock.now)
            if not poll_and_snap() and not poll_and_snap(force=True):
                break               # nothing will ever move again

    for n, report in reports.items():
        sess = manager.session(n)
        report.served = sess.stats.served
        report.percentiles = sess.percentiles()
    return reports
