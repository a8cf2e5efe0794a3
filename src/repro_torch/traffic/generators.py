"""Composable trace generators — timestamped DLRM query streams.

Production recommendation traffic is bursty and non-stationary (Gupta et
al., arxiv 1906.03109: diurnal load swings and flash crowds around a
strict latency SLO), while the paper's sweeps replay a static Zipf trace.
This module fills the gap with a small algebra:

  rate profile (qps over time)   x   hotness model (which rows)
  ------------------------------     ----------------------------
  SteadyRate       constant qps      one `AccessPattern` per table
  DiurnalRate      sinusoidal        (`core.access_patterns`), with an
  FlashCrowdRate   square spike      optional HOTNESS SHIFT: at
                                     `shift_at_s` the rank->row maps
                                     swap to a re-seeded permutation, so
                                     the hot set moves mid-stream — the
                                     trace that exercises refresh,
                                     routing, and live migration.

`TrafficGenerator.queries(n)` emits `TimedQuery`s whose arrival stamps
follow t_{i+1} = t_i + 1/rate(t_i) — deterministic in (profile, seed), so
tests and `repro_torch.examples.serve_dlrm` replay identical offered
load, and the same arguments give the same arrays as `repro.traffic`
(the JAX package's copy of this module). Consumed by
`repro_torch.traffic.replay` on a `VirtualClock`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.access_patterns import make_pattern

#: spreads per-table pattern seeds so tables don't share rank->row maps
_TABLE_SEED_STRIDE = 7919


@dataclasses.dataclass(frozen=True)
class TimedQuery:
    """One query of a timestamped stream (arrival in trace seconds)."""
    qid: int
    arrival_s: float
    dense: np.ndarray       # [F] float32
    indices: np.ndarray     # [T, L] int32


# -- rate profiles (qps over trace time) -------------------------------------
@dataclasses.dataclass(frozen=True)
class SteadyRate:
    """Constant offered load."""
    qps: float

    def __post_init__(self):
        if self.qps <= 0:
            raise ValueError("qps must be positive")

    def rate(self, t_s: float) -> float:
        return self.qps


@dataclasses.dataclass(frozen=True)
class DiurnalRate:
    """Sinusoidal day/night swing: base * (1 + amplitude*sin(2πt/period)).

    `amplitude` < 1 keeps the rate strictly positive (an offered load of
    zero would stall the arrival recurrence)."""
    base_qps: float
    amplitude: float = 0.5
    period_s: float = 60.0
    phase: float = 0.0

    def __post_init__(self):
        if self.base_qps <= 0:
            raise ValueError("base_qps must be positive")
        if not (0.0 <= self.amplitude < 1.0):
            raise ValueError("amplitude must be in [0, 1)")
        if self.period_s <= 0:
            raise ValueError("period_s must be positive")

    def rate(self, t_s: float) -> float:
        return self.base_qps * (1.0 + self.amplitude * math.sin(
            2.0 * math.pi * t_s / self.period_s + self.phase))


@dataclasses.dataclass(frozen=True)
class FlashCrowdRate:
    """Square spike: `base_qps` except `spike_qps` during
    [spike_start_s, spike_start_s + spike_len_s) — the overload trace the
    SLO controller and admission shedding are tested against."""
    base_qps: float
    spike_qps: float
    spike_start_s: float
    spike_len_s: float

    def __post_init__(self):
        if self.base_qps <= 0 or self.spike_qps <= 0:
            raise ValueError("rates must be positive")
        if self.spike_len_s <= 0:
            raise ValueError("spike_len_s must be positive")

    def in_spike(self, t_s: float) -> bool:
        return (self.spike_start_s <= t_s
                < self.spike_start_s + self.spike_len_s)

    def rate(self, t_s: float) -> float:
        return self.spike_qps if self.in_spike(t_s) else self.base_qps


class TrafficGenerator:
    """Timestamped query stream = rate profile x per-table hotness.

    Deterministic: `queries(n)` is a pure function of the constructor
    arguments — two generators built alike emit byte-identical streams
    (the reproducibility contract a `--seed` flag relies on).

    `shift_at_s` arms the hotness-shift axis: queries arriving at or
    after it sample from patterns re-seeded with `shift_seed`, which
    re-scatters every table's rank->row map — same marginal hotness, a
    disjointly placed hot set. Cache hit rates crater at the shift and
    recover only through warm re-admission and hot-set refresh.
    """

    def __init__(self, profile, *, num_tables: int, rows: int, pooling: int,
                 dense_features: int = 13, hotness: str = "med_hot",
                 seed: int = 0, shift_at_s: Optional[float] = None,
                 shift_seed: Optional[int] = None):
        self.profile = profile
        self.num_tables = int(num_tables)
        self.rows = int(rows)
        self.pooling = int(pooling)
        self.dense_features = int(dense_features)
        self.hotness = hotness
        self.seed = int(seed)
        self.shift_at_s = shift_at_s
        if shift_seed is None:
            shift_seed = self.seed + 104_729   # disjoint seed stream
        self.shift_seed = int(shift_seed)
        self._patterns = self._make_patterns(self.seed)
        self._shifted = (None if shift_at_s is None
                         else self._make_patterns(self.shift_seed))

    def _make_patterns(self, seed: int):
        return [make_pattern(self.hotness, self.rows,
                             seed=seed + _TABLE_SEED_STRIDE * t)
                for t in range(self.num_tables)]

    def arrival_times(self, n: int) -> np.ndarray:
        """[n] arrival stamps via t_{i+1} = t_i + 1/rate(t_i), t_0 = 0."""
        t = np.empty(n, np.float64)
        now = 0.0
        for i in range(n):
            t[i] = now
            now += 1.0 / self.profile.rate(now)
        return t

    def queries(self, n: int) -> list[TimedQuery]:
        """The first `n` queries of the stream (deterministic, repeatable).

        Indices are sampled per hotness regime in one block per table (the
        `AccessPattern.sample` idiom), then interleaved back in arrival
        order, so adding a shift changes WHICH rows are hot without
        perturbing the pre-shift stream."""
        arrivals = self.arrival_times(n)
        rng = np.random.default_rng(self.seed ^ 0xD15E)
        dense = rng.normal(size=(n, self.dense_features)).astype(np.float32)
        idx = np.empty((n, self.num_tables, self.pooling), np.int32)

        if self._shifted is None:
            pre = np.arange(n)
            segments = [(self._patterns, pre, 0)]
        else:
            pre = np.flatnonzero(arrivals < self.shift_at_s)
            post = np.flatnonzero(arrivals >= self.shift_at_s)
            segments = [(self._patterns, pre, 0), (self._shifted, post, 1)]
        for patterns, rows_of, regime in segments:
            if rows_of.size == 0:
                continue
            for t, pattern in enumerate(patterns):
                idx[rows_of, t] = pattern.sample(
                    len(rows_of), self.pooling,
                    seed=self.seed * 2 + regime)
        return [TimedQuery(qid=i, arrival_s=float(arrivals[i]),
                           dense=dense[i], indices=idx[i])
                for i in range(n)]


TRACE_KINDS = ("steady", "diurnal", "flash", "shift")


def make_traffic(kind: str, *, base_qps: float, num_tables: int, rows: int,
                 pooling: int, dense_features: int = 13,
                 hotness: str = "med_hot", seed: int = 0,
                 # diurnal knobs
                 amplitude: float = 0.5, period_s: float = 60.0,
                 # flash knobs (spike_qps defaults to 8x base)
                 spike_qps: Optional[float] = None,
                 spike_start_s: float = 1.0, spike_len_s: float = 1.0,
                 # shift knobs
                 shift_at_s: float = 1.0,
                 shift_seed: Optional[int] = None) -> TrafficGenerator:
    """Factory for the four named trace kinds (the `--trace` flag's
    vocabulary): `steady` Zipf, `diurnal` sinusoid, `flash`-crowd spike,
    and hotness-`shift`. Unused knobs for the selected kind are ignored."""
    if kind == "steady":
        profile, shift = SteadyRate(base_qps), None
    elif kind == "diurnal":
        profile = DiurnalRate(base_qps, amplitude=amplitude,
                              period_s=period_s)
        shift = None
    elif kind == "flash":
        profile = FlashCrowdRate(
            base_qps,
            spike_qps=8.0 * base_qps if spike_qps is None else spike_qps,
            spike_start_s=spike_start_s, spike_len_s=spike_len_s)
        shift = None
    elif kind == "shift":
        profile, shift = SteadyRate(base_qps), shift_at_s
    else:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"one of {TRACE_KINDS}")
    return TrafficGenerator(profile, num_tables=num_tables, rows=rows,
                            pooling=pooling, dense_features=dense_features,
                            hotness=hotness, seed=seed, shift_at_s=shift,
                            shift_seed=shift_seed)
