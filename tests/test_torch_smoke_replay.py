"""The flash-crowd scenario `chip_smoke.py`'s replay_tiered phase replays
on the card, rehearsed here on a modelled service time.

The phase times its trace and sets its SLO from three calibration batches,
and the card's host serves those batches faster or slower than the
replay's own (1.17x slower in one full run). The scenario must reach the
degraded rung and come back to level 0 whatever that ratio, within a
range the card can show. Here the port's real session, batcher, SLO ladder
and replay run over a stub tiered storage whose every batch costs a
modelled time: a line through the card's measured batches (3.45 s for 128
queries, 0.2 s for 16 degraded ones), read through a patched
`server.time`."""
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.core.access_patterns import make_pattern  # noqa: E402
from repro_torch.serving import server  # noqa: E402
from repro_torch.storage.base import StorageCapabilities  # noqa: E402
from repro_torch.traffic import replay  # noqa: E402

FULL_S = 3.45           # one exact batch of 128 on the card's host
DEGRADED_16_S = 0.2     # one degraded batch of 16


def _service_s(n: int, degraded: bool, intercept: float) -> float:
    if degraded:
        return DEGRADED_16_S * (0.7 + 0.3 * n / 16)
    return intercept + (FULL_S - intercept) * n / 128


class _Storage:
    """What the session, the ladder and the replay call on a tiered
    backend: tunable and degradable, host-backed, nothing staged."""

    def __init__(self):
        self.is_degraded = False
        self.depth = 2

    def capabilities(self):
        return StorageCapabilities(tunable=True, degradable=True)

    def prefetch_depth(self):
        return self.depth

    def set_prefetch_depth(self, depth):
        self.depth = int(depth)
        return True

    def degraded(self):
        return self.is_degraded

    def set_degraded(self, on):
        self.is_degraded = bool(on)
        return True

    def update_routing(self):
        return None

    def can_stage(self):
        return False

    def hint_valid(self, n):
        pass

    def stats(self):
        return {}

    def flush(self):
        pass

    def reset_stats(self):
        pass

    def close(self):
        pass


class _EBC:
    """A tiered collection's lookup: each call advances `clock` by the
    modelled service time of its batch."""

    def __init__(self, clock, intercept: float, seed: int):
        self.storage = _Storage()
        self.clock = clock
        self.intercept = intercept
        self.rng = np.random.default_rng(seed)

    def __call__(self, idx):
        self.clock[0] += _service_s(
            len(idx), self.storage.is_degraded,
            self.intercept) * self.rng.uniform(0.92, 1.08)
        return torch.zeros(len(idx), 1)


class _Model:
    """A tiered DLRM's serving surface at a tiny width."""

    def __init__(self, clock, intercept: float, seed: int):
        self.device = torch.device("cpu")
        self.cfg = types.SimpleNamespace(
            dense_features=2,
            embedding=types.SimpleNamespace(num_tables=2, rows=1000,
                                            pooling=2))
        self.ebc = _EBC(clock, intercept, seed)

    def forward_from_pooled(self, dense, pooled):
        return torch.zeros(dense.shape[0], 1)


@pytest.mark.parametrize("intercept", [0.1, 0.5])
@pytest.mark.parametrize("cal_ratio", [0.7, 1.0, 1.17, 1.5, 2.0])
def test_replay_tiered_reaches_the_degraded_rung_and_recovers(
        monkeypatch, cal_ratio, intercept):
    clock = [0.0]
    monkeypatch.setattr(server, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    model = _Model(clock, intercept, seed=0)
    lat = cal_ratio * FULL_S * np.array([1.0, 0.97, 1.03])
    pattern = make_pattern("med_hot", model.cfg.embedding.rows, seed=0)
    sess, queries, profile, target_ms = chip_smoke.replay_tiered_scenario(
        model, pattern, lat)
    assert len(queries) == chip_smoke.REPLAY_TIERED_QUERIES
    assert target_ms == pytest.approx(
        chip_smoke.REPLAY_TIERED_TARGET_X * FULL_S * cal_ratio * 1e3)
    assert sess.server.batcher.cfg.deadline_ms == pytest.approx(
        target_ms * chip_smoke.REPLAY_TIERED_DEADLINE_FRAC)
    rep = replay(sess, queries,
                 window_queries=chip_smoke.REPLAY_TIERED_WINDOW)
    sess.close()
    tl = rep.timeline
    levels = [s.slo_level for s in tl]
    degraded = [s.degraded for s in tl]
    # the phase's checks on the ladder
    assert max(levels) == 3, levels
    assert levels[-1] == 0, levels
    assert any(degraded) and not all(degraded)
    assert rep.served + rep.shed == len(queries)
