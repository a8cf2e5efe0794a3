"""One composition point for every serving-loop controller.

`ServingControllers` is the single spec that names the inner auto-tuners,
the SLO outer loop, the cross-tenant arbiter and online model updates:

    controllers = serving.configure(
        auto_tune=AutoTuneConfig(capacity_every_batches=32),
        slo=SLOConfig(target_p99_ms=8.0, min_batch=8),
        updates=UpdateConfig(stream=ModelUpdateStream(root)),
    )
    ServingSession(model, controllers=controllers)

The per-controller kwargs (`ServingSession(auto_tune=..., slo=...)`)
remain as thin aliases — they build the same `ServingControllers` under
the hood, and passing both surfaces at once is a `ValueError`, not a
silent precedence rule. The `arbiter` field is meaningful only for a
multi-tenant manager (it arbitrates ACROSS tenants; ROADMAP.md Queue 1
item 11); a single-model session rejects it for the same fail-fast
reason.

A port of `repro/serving/config.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from repro_torch.ps.tuning import ArbiterConfig, AutoTuneConfig
from repro_torch.serving.slo import SLOConfig


@dataclasses.dataclass(frozen=True)
class UpdateConfig:
    """Zero-downtime online model updates for a serving session.

    `stream` is a `repro_torch.checkpoint.ModelUpdateStream` (or anything
    with its `poll()` surface returning update records). The session polls
    it between batches — every `poll_every_batches` executed batches — and
    applies new versions through the storage `begin_update / apply_update
    / commit_update` protocol behind the epoch guard: in-flight queries
    stay pinned to the version current at their admission, and the commit
    barrier drains them before the swap becomes visible.

    `drain_timeout_s` bounds the commit barrier — how long the session
    will spend force-flushing pinned in-flight batches before a version
    swap (the stall is accounted in `percentiles()['update_stall_s']`)."""

    stream: Any
    poll_every_batches: int = 1
    drain_timeout_s: float = 10.0

    def __post_init__(self):
        if self.stream is None or not hasattr(self.stream, "poll"):
            raise ValueError(
                "UpdateConfig.stream must expose poll() — pass a "
                "repro_torch.checkpoint.ModelUpdateStream")
        if self.poll_every_batches < 1:
            raise ValueError(
                f"poll_every_batches must be >= 1, got "
                f"{self.poll_every_batches}")


@dataclasses.dataclass(frozen=True)
class ServingControllers:
    """The full controller stack for a session: inner auto-tuners, SLO
    outer loop, cross-tenant arbiter, online model updates. Any field
    left None leaves that controller off."""

    auto_tune: Union[AutoTuneConfig, bool, None] = None
    slo: Optional[SLOConfig] = None
    arbiter: Optional[ArbiterConfig] = None
    updates: Optional[UpdateConfig] = None

    def __post_init__(self):
        # normalize the auto_tune=True shorthand here so every consumer
        # sees a real config (or None) — one coercion point
        if self.auto_tune is True:
            object.__setattr__(self, "auto_tune", AutoTuneConfig())
        elif self.auto_tune is False:
            object.__setattr__(self, "auto_tune", None)


def configure(*, auto_tune: Union[AutoTuneConfig, bool, None] = None,
              slo: Optional[SLOConfig] = None,
              arbiter: Optional[ArbiterConfig] = None,
              updates: Optional[UpdateConfig] = None) -> ServingControllers:
    """Build a `ServingControllers` spec (keyword-only, so call sites
    read like the config they produce)."""
    return ServingControllers(auto_tune=auto_tune, slo=slo, arbiter=arbiter,
                              updates=updates)


def resolve_controllers(controllers: Optional[ServingControllers],
                        auto_tune: Union[AutoTuneConfig, bool, None],
                        slo: Optional[SLOConfig],
                        *, where: str) -> ServingControllers:
    """Fold the per-controller kwargs and the unified spec into ONE
    `ServingControllers`, refusing ambiguity: the kwargs are exact
    aliases, so mixing them with `controllers=` has no sane precedence."""
    legacy = auto_tune is not None or slo is not None
    if controllers is not None:
        if legacy:
            raise ValueError(
                f"{where} got both controllers= and the legacy "
                "auto_tune=/slo= kwargs — pass ONE surface (the legacy "
                "kwargs are aliases for serving.configure(...))")
        return controllers
    return ServingControllers(auto_tune=auto_tune, slo=slo)
