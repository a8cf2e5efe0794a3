"""The `EmbeddingStorage` protocol — one pluggable surface for every way the
embedding stage can back its tables.

The paper's techniques (software prefetching §IV-B, L2 pinning + periodic
re-pinning §IV-C) are plug-and-play *mechanisms*; this module is the plug.
A backend owns table placement and exposes the verbs the rest of the stack
programs against:

  lookup(indices, weights)              — the data path: pooled embeddings.
  stage(next_indices) / can_stage()     — prefetch: pre-resolve a FUTURE
                                          batch's misses (overlap hook).
  plan_refresh(window) / install_refresh(plan) / refresh()
                                        — periodic re-pinning, split into a
                                          pure planning phase (helper-thread
                                          safe) and a mutating install.
  set_degraded() / set_prefetch_depth() / retune_capacities()
                                        — overload and runtime-tuning knobs.
  update_routing() / plan_migration() / install_migration()
                                        — live placement (replica routing,
                                          table migration); inert here.
  begin/apply/commit/abort_update()     — online model updates, with
  version()                               `version()` the committed one.
  stats() / reset_stats() / flush()     — counters and cache hygiene.
  close()                               — release workers/buffers.

`capabilities()` returns a static descriptor so generic drivers (the
`ServingSession` facade, `InferenceServer`) can decide which verbs are
worth calling — and a caller who requires a capability fails fast with
`require_capability` instead of silently losing overlap.

The live-placement verbs are called by the SLO controller and the
auto-tuner on every backend; only a sharded backend (ROADMAP.md Queue 1
item 9, with its `shardable` flag) would report `migratable` and give them
work. `device` and `tiered` keep the inert defaults.

Backends register under a string key in `repro_torch.storage.registry`;
`EmbeddingStageConfig.storage` is a thin lookup into that registry.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar, Optional

import numpy as np


class CapabilityError(RuntimeError):
    """A caller required a capability the selected backend does not offer."""


@dataclasses.dataclass(frozen=True)
class StorageCapabilities:
    """What a backend instance can do, as currently configured.

    Instance-level on purpose: a tiered backend built with
    `prefetch_depth=0` is not stageable even though the class could be.
    """
    # lookups run end to end on the device (tables live in device memory);
    # False means the lookup is a host call and only pooling runs on device
    device_resident: bool = False
    # stage()/can_stage() do real prefetch work (staged future batches)
    stageable: bool = False
    # staged gathers resolve on a background worker (true compute overlap);
    # implies stageable
    async_prefetch: bool = False
    # plan_refresh()/install_refresh() re-pin a hot set from live traffic
    refreshable: bool = False
    # runtime auto-tuning hooks are live: set_prefetch_depth() moves the
    # bounded prefetch buffer, retune_capacities() re-splits a device-byte
    # budget into tier capacities. False (the default) means the hooks are
    # inert no-ops.
    tunable: bool = False
    # update_routing()/plan_migration()/install_migration() re-route and
    # re-place tables live. False (the default) means the verbs are inert
    # no-ops and the auto-tuner's routing and migration legs never run.
    migratable: bool = False
    # set_degraded(True) switches to warm-cache-only serving: device-tier
    # hits stay exact, cold misses are zero-filled (never gathered, never
    # cached), and the zero-fills' exact L2 error vs the dense gather is
    # tallied in stats(). False (the default) means set_degraded is an
    # inert no-op.
    degradable: bool = False
    # lookup() serves warm/hot hits through the fused kernel path: slot-map
    # build -> one fused launch (hit gather + pooled sum + miss list) ->
    # host cold path only for the emitted misses. Requires
    # PSConfig.fused_lookup=True and a device-resident warm payload; the
    # per-row path serves otherwise (same bits either way).
    fused_lookup: bool = False
    # online model updates: begin_update()/apply_update()/commit_update()/
    # abort_update() install a NEW weight version transactionally — applied
    # rows stay invisible to lookups until commit, abort keeps serving the
    # old version, and version() reports the committed version. False (the
    # default) means all the update verbs are inert no-ops.
    updatable: bool = False

    def describe(self) -> str:
        on = [f.name for f in dataclasses.fields(self)
              if getattr(self, f.name)]
        return "+".join(on) if on else "none"


def require_capability(storage: "EmbeddingStorage", *names: str) -> None:
    """Fail fast when `storage` lacks any of `names` (capability fields).

    Raises `CapabilityError` naming the backend, what it does offer, and
    the standard remedy — the error every generic driver surfaces instead
    of silently degrading (e.g. `async_prefetch` requested on `device`).
    """
    caps = storage.capabilities()
    valid = {f.name for f in dataclasses.fields(caps)}
    for name in names:
        if name not in valid:
            raise ValueError(f"unknown capability {name!r}; one of "
                             f"{sorted(valid)}")
        if not getattr(caps, name):
            raise CapabilityError(
                f"backend {storage.name!r} does not support {name!r} "
                f"(offers: {caps.describe()}); pick an async-capable "
                f"backend or reconfigure it (e.g. tiered with "
                f"async_prefetch=True, prefetch_depth>0)")


class EmbeddingStorage(abc.ABC):
    """Abstract base for embedding-storage backends.

    A backend binds to one `EmbeddingBagCollection` (`self.ebc`) whose
    `EmbeddingStageConfig` (`self.cfg`) fixes the table geometry
    [num_tables, rows, dim] and pooling. The collection keeps owning
    parameter init and the hot-first index remap; the backend owns
    placement and lookup.

    Contract highlights (the tests pin these down):
      * `lookup()` equals a dense `table[indices]` gather + the shared
        pooling reduction, whatever the placement.
      * Every mutating verb (`lookup`, `stage`, `install_refresh`,
        `flush`) is called from ONE serving thread; internal concurrency
        (prefetch workers) never escapes the backend.
      * The default implementations below are correct no-ops, so a
        minimal backend only implements `capabilities()` and `lookup()`
        and generic drivers still work.
    """

    #: registry key; set by `repro_torch.storage.registry.register`
    name: ClassVar[str] = "?"

    def __init__(self, ebc):
        self.ebc = ebc
        self.cfg = None if ebc is None else ebc.cfg

    # -- descriptor ---------------------------------------------------------
    @abc.abstractmethod
    def capabilities(self) -> StorageCapabilities:
        ...

    # -- construction -------------------------------------------------------
    def build(self, **kwargs) -> "EmbeddingStorage":
        """Materialize backend state from the collection's tables.

        Device-resident backends need nothing (the collection's `tables`
        buffer IS the storage); host-tiered backends move the tables into
        their hierarchy here. Returns self for chaining."""
        if kwargs:
            raise TypeError(f"backend {self.name!r} takes no build "
                            f"options, got {sorted(kwargs)}")
        return self

    # -- data path ----------------------------------------------------------
    @abc.abstractmethod
    def lookup(self, indices, weights=None, *,
               pre_remapped: bool = False):
        """indices [B, T, L] -> pooled [B, T, D]."""
        ...

    # -- prefetch (overlap) hooks -------------------------------------------
    def can_stage(self) -> bool:
        """Backpressure probe; False also means 'staging unsupported'."""
        return False

    def stage(self, next_indices: np.ndarray) -> bool:
        """Pre-resolve a FUTURE batch's misses. Correctness-neutral."""
        return False

    def hint_valid(self, n: int) -> None:
        """Only the first `n` queries of the NEXT lookup are real traffic
        (the rest is batcher padding). No-op for stats-free backends."""

    # -- refresh (re-pinning) hooks -----------------------------------------
    def refresh_window(self) -> Any:
        """Snapshot of the traffic window `plan_refresh` plans from — taken
        on the serving thread so the plan phase can run on a helper."""
        return []

    def plan_refresh(self, window: Any = None) -> Any:
        """Phase 1: pure re-planning (helper-thread safe). None = nothing
        to plan."""
        return None

    def install_refresh(self, plan: Any) -> dict:
        """Phase 2: swap the plan in (serving thread only). Returns at
        least {'replanned': bool}."""
        return {"replanned": False, "refreshes": 0}

    def refresh(self) -> dict:
        """Synchronous re-pin: plan + install in one call."""
        return self.install_refresh(self.plan_refresh(self.refresh_window()))

    # -- runtime tuning hooks -----------------------------------------------
    def prefetch_depth(self) -> int:
        """Current bounded-buffer depth of the prefetch engine (0 = staging
        off / unsupported)."""
        return 0

    def set_prefetch_depth(self, depth: int) -> bool:
        """Runtime queue-depth control: move the prefetch buffer bound.
        Returns False when the backend has no prefetch engine to tune (the
        inert default — `device` stays a no-op by design)."""
        return False

    def take_prefetch_window_peak(self) -> int:
        """Peak prefetch-queue occupancy since the previous call (the
        auto-tuner's per-window observation; resets the window)."""
        return 0

    def retune_capacities(self, budget_bytes: int) -> Optional[dict]:
        """Re-split a LIVE device-byte budget into tier capacities from the
        backend's recent traffic window. None = nothing to retune (the
        inert default)."""
        return None

    # -- degraded-mode (overload) hooks --------------------------------------
    def degraded(self) -> bool:
        """Whether warm-cache-only serving is currently on."""
        return False

    def set_degraded(self, on: bool) -> bool:
        """Toggle warm-cache-only serving (see the `degradable` capability).
        Returns False when the backend cannot degrade (the inert default —
        `device` serves everything from device memory and never needs
        to)."""
        return False

    # -- live placement hooks -----------------------------------------------
    def update_routing(self) -> Optional[dict]:
        """Refresh load-aware replica routing from the latest window of
        per-replica service-cost observations. None = nothing to route
        (the inert default — backends without replicated placement)."""
        return None

    def plan_migration(self, window: Any = None, *,
                       threshold: Optional[float] = None) -> Any:
        """Phase 1 of live migration (pure, helper-thread safe): re-plan
        table placement from the live traffic window; None (the inert
        default) when the placement is fine."""
        return None

    def install_migration(self, plan: Any) -> dict:
        """Phase 2 of live migration (serving thread only): apply a
        `plan_migration` result. Returns at least {'migrated': bool}."""
        return {"migrated": False}

    # -- online model update hooks ------------------------------------------
    def version(self) -> int:
        """Currently COMMITTED model version (0 = the build-time weights).
        Lookups always serve exactly this version's bytes — an open
        update transaction is invisible until `commit_update`."""
        return 0

    def begin_update(self, version: int) -> bool:
        """Open an update transaction targeting `version` (> the committed
        version; one transaction at a time). Returns False when the
        backend cannot update (the inert default)."""
        return False

    def apply_update(self, table: int, rows: np.ndarray,
                     values: np.ndarray) -> bool:
        """Buffer changed rows (`rows` [n] ints, `values` [n, D]) for the
        open transaction. NOT visible to lookups until commit."""
        return False

    def commit_update(self, version: int) -> dict:
        """Atomically publish the open transaction and advance `version()`.
        Returns at least {'updated': bool}."""
        return {"updated": False}

    def abort_update(self, version: int) -> bool:
        """Discard the open transaction; the old version keeps serving
        untouched."""
        return False

    # -- stats & hygiene ----------------------------------------------------
    def stats(self) -> dict:
        return {}

    def reset_stats(self) -> None:
        pass

    def flush(self) -> None:
        """Drop cached/staged state after synthetic traffic (warmup)."""

    def close(self) -> None:
        """Release workers and buffers. Idempotent."""

    def __enter__(self) -> "EmbeddingStorage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} name={self.name!r} "
                f"caps={self.capabilities().describe()}>")
