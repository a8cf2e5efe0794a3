"""The `EmbeddingStorage` protocol — one pluggable surface for every way the
embedding stage can back its tables.

A backend owns table placement and exposes the verbs the rest of the stack
programs against:

  lookup(indices, weights)              — the data path: pooled embeddings.
  begin/apply/commit/abort_update()     — online model updates, with
  version()                               `version()` the committed one.
  stats() / reset_stats() / flush()     — counters and cache hygiene.
  close()                               — release workers/buffers.

`capabilities()` returns a static descriptor so generic drivers (the
`ServingSession` facade) can pick their engine from it.

This slice ports the verbs the `device` backend uses. The TPU path's
staging (prefetch), hot-set refresh, auto-tuning, degraded-mode and
migration verbs arrive with the tiered and sharded backends that need them
(ROADMAP.md Queue 1).

Backends register under a string key in `repro_torch.storage.registry`;
`EmbeddingStageConfig.storage` is a thin lookup into that registry.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar

import numpy as np


@dataclasses.dataclass(frozen=True)
class StorageCapabilities:
    """What a backend instance can do, as currently configured."""
    # lookups run end to end on the device (tables live in device memory);
    # False means the lookup is a host call and only pooling runs on device
    device_resident: bool = False
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
      * Every mutating verb is called from ONE serving thread.
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
        buffer IS the storage). Returns self for chaining."""
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
        """Drop cached state after synthetic traffic (warmup)."""

    def close(self) -> None:
        """Release workers and buffers. Idempotent."""

    def __enter__(self) -> "EmbeddingStorage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} name={self.name!r} "
                f"caps={self.capabilities().describe()}>")
