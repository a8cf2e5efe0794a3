"""SLO outer-loop controller — hold a windowed p99 target under overload.

The auto-tuners (`repro_torch.ps.tuning`) optimize steady-state overlap
and placement; they have no notion of a latency TARGET. Production DLRM
serving is framed the other way around (Gupta et al., arxiv 1906.03109):
maximize goodput under a strict tail-latency SLO, and when offered load
exceeds capacity, shed or degrade rather than queue without bound. This
module is that outer loop:

  watch   — windowed p99 over the most recent `window_queries` query
            latencies from `ServeStats`, checked every
            `check_every_batches` executed batches.
  trade   — on a breach, escalate one rung per check up a small ladder:
              level 1: widen the prefetch bounded buffer (more overlap
                       lead time, reusing the `set_prefetch_depth` verb)
                       and refresh replica routing (`update_routing`) so
                       a slow replica sheds load NOW instead of at the
                       next auto-tune interval;
              shrink : with `min_batch > 0` and a batcher handle, halve
                       the batcher's `max_batch` (and its batching window
                       proportionally) one rung per breached check down
                       to the floor — smaller batches clear the queue in
                       shorter service quanta, trading throughput for
                       tail latency BEFORE any answer quality is touched;
              degrade: warm-cache-only degraded serving
                       (`storage.set_degraded(True)`) — zero-filled cold
                       misses with a measured accuracy delta, the
                       cache-only answer tier of GPU-specialized
                       parameter servers (arxiv 2210.08804).
            Recovery runs the same ladder downward, one rung per check,
            only once p99 is back below `recover_frac * target` — the
            hysteresis band that keeps the controller from flapping on a
            target-straddling workload.
  yield   — while the controller is engaged (level >= 1) it OWNS the
            prefetch depth: the `AutoTuner`'s queue-depth leg is
            suspended (`tuner.depth_suspended`), so the two controllers
            can never fight — the SLO loop only ever widens, the depth
            leg would narrow on the idle-slot signal a breach produces,
            and alternating the two is the oscillation the tests pin
            down. The capacity/routing/migration legs keep running.

Load shedding itself lives in the Batcher (`BatcherConfig.max_queue` /
`deadline_ms`, typed `QueryShedError`); `ServingSession(slo=...)` arms it
with a deadline derived from the target when none is configured, so "the
queue deadline budget is blown" and "the SLO target" are the same number
by default.

A copy of `repro/serving/slo.py`: the same scripted latencies give the
same levels, actions and verb calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def windowed_p99_ms(latencies_s, window: int) -> Optional[float]:
    """p99 (ms) over the most recent `window` entries of a latency list —
    the controller's and the replay timeline's shared definition. None
    when no queries have completed yet."""
    if not latencies_s:
        return None
    tail = np.asarray(latencies_s[-window:], np.float64)
    return float(np.percentile(tail * 1e3, 99))


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Target and cadence for the SLO outer loop.

    `target_p99_ms` is the contract; everything else shapes how hard the
    controller works to hold it. `shed_deadline_frac` > 0 lets
    `ServingSession` derive the Batcher's deadline budget from the target
    when the caller didn't set one (0 disables that coupling).
    """

    target_p99_ms: float
    # windowed p99: most recent N query latencies (small enough to see a
    # spike end, large enough that one batch can't swing the percentile)
    window_queries: int = 256
    # evaluate every N executed batches
    check_every_batches: int = 4
    # de-escalate only below recover_frac * target (hysteresis band)
    recover_frac: float = 0.7
    # breach response: widen the prefetch bounded buffer up to this bound
    max_prefetch_depth: int = 8
    # allow the degraded (warm-cache-only) rung on capable backends
    degrade: bool = True
    # refresh replica routing on every breached check
    route_on_breach: bool = True
    # default Batcher deadline budget = frac * target (0 = don't arm)
    shed_deadline_frac: float = 1.0
    # batch-shrink rung: on a sustained breach, halve the batcher's
    # max_batch (scaling its wait window proportionally) down to this
    # floor BEFORE the degraded rung — 0 disables the rung entirely
    min_batch: int = 0

    def __post_init__(self):
        if self.target_p99_ms <= 0:
            raise ValueError("target_p99_ms must be positive")
        if not (0.0 < self.recover_frac < 1.0):
            raise ValueError("recover_frac must be in (0, 1) — it is the "
                             "hysteresis band below the target")
        if self.min_batch < 0:
            raise ValueError("min_batch must be >= 0 (0 disables the "
                             "batch-shrink rung)")


class SLOController:
    """Escalation-ladder controller over the `EmbeddingStorage` verbs.

    `step()` once per executed batch (the session wires this into its
    poll). All actions go through protocol verbs, so backends without a
    capability simply skip that rung: `device` (neither tunable nor
    degradable) leaves only routing refreshes, which are themselves inert
    no-ops there — the controller still measures and logs breaches.
    """

    def __init__(self, cfg: SLOConfig, storage, stats, tuner=None,
                 batcher=None):
        self.cfg = cfg
        self.storage = storage
        self.stats = stats
        self.tuner = tuner              # AutoTuner to suspend, if any
        self.batcher = batcher          # Batcher to shrink, if any
        caps = storage.capabilities()
        self._tunable = caps.tunable
        self._degradable = caps.degradable and cfg.degrade
        self._base_depth = storage.prefetch_depth()
        # ladder: 0 healthy, 1 widened, [2 shrunken,] top rung degraded.
        # The shrink rung exists only when armed (min_batch > 0 AND a
        # batcher handle), so the degraded rung's level depends on it.
        self._shrinkable = cfg.min_batch > 0 and batcher is not None
        self._base_batch_cfg = batcher.cfg if batcher is not None else None
        self._degrade_level = 3 if self._shrinkable else 2
        self.level = 0
        self.batches = 0
        self.breaches = 0
        self.batch_shrinks = 0
        self.degraded_batches = 0
        self.events: list[dict] = []

    @property
    def engaged(self) -> bool:
        return self.level > 0

    def windowed_p99_ms(self) -> Optional[float]:
        return windowed_p99_ms(self.stats.query_latencies_s,
                               self.cfg.window_queries)

    def step(self) -> None:
        """One executed batch. Cheap off-boundary (two increments); on the
        check boundary, evaluate the window and move at most ONE rung."""
        self.batches += 1
        if self.level >= self._degrade_level:
            self.degraded_batches += 1
        # ownership must be published every batch, not just on check
        # boundaries: the depth leg's own interval is independent of ours
        # and could fire in between
        if self.tuner is not None:
            self.tuner.depth_suspended = self.engaged
        if self.batches % self.cfg.check_every_batches:
            return
        p99 = self.windowed_p99_ms()
        if p99 is None:
            return
        if p99 > self.cfg.target_p99_ms:
            self._escalate(p99)
        elif p99 < self.cfg.target_p99_ms * self.cfg.recover_frac:
            self._deescalate(p99)
        if self.tuner is not None:
            self.tuner.depth_suspended = self.engaged

    # -- ladder --------------------------------------------------------------
    def _log(self, action: str, p99: float) -> None:
        self.events.append({"kind": "slo", "action": action,
                            "batch": self.batches, "level": self.level,
                            "p99_ms": round(p99, 3)})

    def _escalate(self, p99: float) -> None:
        self.breaches += 1
        if self.cfg.route_on_breach:
            # inert None on non-replicated placements; on a routed sharded
            # backend this folds the freshest replica costs in immediately
            self.storage.update_routing()
        if self._tunable:
            # every breached check widens once more, monotonically, up to
            # the bound — never narrows, which is what makes suspension of
            # the depth leg sufficient to rule out a tug-of-war
            depth = self.storage.prefetch_depth()
            if 0 < depth < self.cfg.max_prefetch_depth:
                self.storage.set_prefetch_depth(depth + 1)
        if self.level == 0:
            self.level = 1
            self._log("widen", p99)
            return
        if self._shrinkable and self.level in (1, 2):
            self.level = 2
            if self._shrink():          # keep halving toward the floor
                self._log("shrink", p99)
                return
            # already at the floor: fall through to the degraded rung
        if self.level == self._degrade_level - 1 and self._degradable:
            self.level = self._degrade_level
            self.storage.set_degraded(True)
            self._log("degrade", p99)
        # at the top rung with a sustained breach: admission shedding
        # (Batcher deadline) is what sheds the rest

    def _shrink(self) -> bool:
        """Halve the batcher's max_batch toward the floor, scaling the
        batching window proportionally (a half-size batch should not wait
        a full-size window to fill). The batcher reads its cfg live, so
        the very next `next_batch` serves the smaller quantum."""
        cfg = self.batcher.cfg
        want = max(self.cfg.min_batch, cfg.max_batch // 2)
        if want >= cfg.max_batch:
            return False
        scale = want / cfg.max_batch
        self.batcher.cfg = dataclasses.replace(
            cfg, max_batch=want, max_wait_s=cfg.max_wait_s * scale)
        self.batch_shrinks += 1
        return True

    def _deescalate(self, p99: float) -> None:
        if self.level == self._degrade_level:
            self.level -= 1
            self.storage.set_degraded(False)
            self._log("restore_exact", p99)
        elif self._shrinkable and self.level == 2:
            self.level = 1
            self.batcher.cfg = self._base_batch_cfg
            self._log("regrow", p99)
        elif self.level == 1:
            self.level = 0
            if self._tunable and self._base_depth > 0:
                self.storage.set_prefetch_depth(self._base_depth)
            self._log("recover", p99)

    # -- reporting -----------------------------------------------------------
    def summary(self) -> dict:
        """Merged into `ServingSession.percentiles()` when an SLO is set."""
        return {"slo_target_p99_ms": self.cfg.target_p99_ms,
                "slo_level": self.level,
                "slo_breaches": self.breaches,
                "slo_batch_shrinks": self.batch_shrinks,
                "slo_degraded_batches": self.degraded_batches}
