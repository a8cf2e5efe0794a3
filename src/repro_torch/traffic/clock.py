"""Virtual serving clock — deterministic trace time for replay harnesses.

The serving loop (`repro_torch.serving`) measures arrivals, batching windows,
and query latencies through an injectable `clock` callable. The default
is `time.perf_counter` (live traffic). `VirtualClock` replaces it for
trace replay: time only moves when something *happens* — the replay
driver advances it to each query's nominal arrival, and the server
advances it by every batch's REAL measured service duration. Offered
load is therefore exactly the trace (host speed cannot reshape it),
while service cost stays honest, which is what lets an SLO replay
compare "controller on" vs "controller off" within one run without
timing flake.
"""
from __future__ import annotations


class VirtualClock:
    """A monotonic counter of virtual seconds.

    Duck-typed against the serving layer's expectations: calling it
    returns the current time, and the presence of `advance()` is how
    `InferenceServer`/`Batcher.drain` detect they are on trace time.
    """

    def __init__(self, start_s: float = 0.0):
        self.now = float(start_s)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt_s: float) -> float:
        """Move time forward by `dt_s` seconds; returns the new now.
        Negative advances are a driver bug (virtual time is monotonic)."""
        if dt_s < 0:
            raise ValueError(f"virtual time cannot move backwards "
                             f"(advance by {dt_s!r})")
        self.now += float(dt_s)
        return self.now

    def __repr__(self) -> str:
        return f"VirtualClock(now={self.now:.6f})"
