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

A port of `repro/traffic/replay.py`'s single-session driver; the
multi-tenant `replay_tenants` comes with `serving/tenants.py` (ROADMAP.md
Queue 1 item 11).
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
