"""ServingSession — the one-stop facade over batcher + engine + storage.

A session owns all three and wires them from the storage backend's
capability descriptor alone:

  * **engine** — device-resident backends get one eager forward under
    `torch.inference_mode()` that moves each batch to the model's device
    and reads the model's current tensors on every call. Host-backed
    backends (`tiered`) get the split engine: the host lookup returns the
    pooled rows on the card, then `forward_from_pooled` runs the rest.
  * **loop** — an `InferenceServer` batches queries, runs the engine,
    drives prefetch staging and (async) hot-set refresh through the
    protocol verbs, and mirrors the backend's `stats()`.
  * **lifecycle** — warmup runs the engine once on a zero batch (building
    the kernels) then `flush()` + `reset_stats()` so synthetic traffic never
    pollutes the caches or counters; `close()` installs an in-flight
    refresh plan, stops the refresh helper and closes the storage.

Typical use:

    model = DLRM(cfg, device="cuda")        # cfg.embedding.storage="device"
    with ServingSession(model, batcher=BatcherConfig(max_batch=2048)) as s:
        s.submit_batch(dense, indices); s.drain()
        print(s.percentiles())

Not ported yet, and refused with `NotImplementedError`: `auto_tune=`
(ps/tuning.py), `slo=` (serving/slo.py) and `controllers=`
(serving/config.py, including the online-update stream). ROADMAP.md
Queue 1 names the items. The replay clock comes with them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.serving.server import (BatcherConfig, InferenceServer, Query,
                                        QueryShedError)
from repro_torch.storage import require_capability


class ServingSession:
    """Owns batcher + engine + storage for one model."""

    def __init__(self, model, *,
                 batcher: Optional[BatcherConfig] = None,
                 sla_ms: float = 50.0,
                 refresh_every_batches: int = 0,
                 async_refresh: bool = False,
                 auto_tune=None,
                 slo=None,
                 controllers=None,
                 warmup: bool = True):
        for name, value, item in (
                ("auto_tune", auto_tune, "item 9 (ps/tuning.py)"),
                ("slo", slo, "item 8 (serving/slo.py)"),
                ("controllers", controllers, "item 7 (serving/config.py)")):
            if value is not None:
                raise NotImplementedError(
                    f"ServingSession({name}=...) is not ported yet: "
                    f"ROADMAP.md Queue 1 {item}")
        self.model = model
        self.storage = model.ebc.storage
        caps = self.storage.capabilities()
        if (async_refresh or refresh_every_batches) and not caps.refreshable:
            # fail fast instead of silently never re-pinning
            require_capability(self.storage, "refreshable")
        batcher = batcher if batcher is not None else BatcherConfig()
        self.server = InferenceServer(
            self._build_engine(caps), batcher, sla_ms=sla_ms,
            storage=self.storage,
            refresh_every_batches=refresh_every_batches,
            async_refresh=async_refresh)
        self._closed = False
        self._next_qid = 0
        if warmup:
            self._warmup(batcher.max_batch)

    # -- engine -------------------------------------------------------------
    def _build_engine(self, caps):
        """Pick the forward shape from the capability descriptor — the only
        place residency is ever consulted."""
        model = self.model
        if not caps.device_resident:
            def split_forward(dense: np.ndarray,
                              idx: np.ndarray) -> torch.Tensor:
                # the host lookup (numpy indices straight into the tiers)
                # returns pooled rows on the model's device; parameters are
                # read on every call, as in the device engine
                with torch.no_grad():
                    pooled = model.ebc(idx)
                with torch.inference_mode():
                    return model.forward_from_pooled(
                        torch.from_numpy(dense).to(model.device), pooled)
            return split_forward

        def forward(dense: np.ndarray, idx: np.ndarray) -> torch.Tensor:
            # eager, and reading the module's tensors on every call: an
            # online update (written in place into the tables) must be
            # visible on the next batch, so nothing here may capture the
            # weights (no CUDA graph or compiled artefact holding them)
            device = model.device
            with torch.inference_mode():
                return model(torch.from_numpy(dense).to(device),
                             torch.from_numpy(idx).to(device))
        return forward

    def _warmup(self, batch: int) -> None:
        """Run the engine on a zero batch (the kernel builds and loads on
        its first launch), then drop the synthetic traffic's footprint and
        its counters so measurements start clean."""
        cfg = self.model.cfg
        dense = np.zeros((batch, cfg.dense_features), np.float32)
        idx = np.zeros((batch, cfg.embedding.num_tables,
                        cfg.embedding.pooling), np.int32)
        self.server.forward(dense, idx).cpu()
        self.storage.flush()
        self.storage.reset_stats()

    # -- serving loop (delegation) ------------------------------------------
    def submit(self, query: Query) -> None:
        self.server.submit(query)
        # keep the auto-advancing submit_batch counter ahead of manually
        # assigned qids so mixing the two surfaces never reuses an id
        self._next_qid = max(self._next_qid, query.qid + 1)

    def submit_batch(self, dense: np.ndarray, indices: np.ndarray,
                     qid0: Optional[int] = None) -> int:
        """Convenience: enqueue one [B, ...] batch as B queries; returns
        how many were ADMITTED. Shed queries (admission control on an
        overloaded queue) are counted in `stats.shed_queries` rather than
        raised per query — callers who need the typed rejection submit
        single queries through `submit()`.

        Query ids auto-advance from the last issued one; an explicit
        `qid0` re-bases the counter."""
        if qid0 is None:
            qid0 = self._next_qid
        admitted = 0
        for i in range(len(dense)):
            try:
                self.server.submit(Query(qid=qid0 + i, dense=dense[i],
                                         indices=indices[i]))
                admitted += 1
            except QueryShedError:
                pass            # tallied in stats by the server
        self._next_qid = qid0 + len(dense)
        return admitted

    def poll(self, force: bool = False) -> int:
        return self.server.poll(force=force)

    def drain(self, timeout_s: float = 10.0) -> None:
        self.server.drain(timeout_s=timeout_s)

    # -- reporting ----------------------------------------------------------
    @property
    def stats(self):
        return self.server.stats

    def percentiles(self) -> dict:
        """Latency percentiles + whatever counters the bound backend
        reports."""
        return self.server.stats.percentiles()

    def sla_violations(self) -> int:
        return self.server.sla_violations()

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Install any in-flight refresh plan, stop the refresh helper,
        then close the storage backend (prefetch workers). Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self.server.close()
        finally:
            self.storage.close()

    def __enter__(self) -> "ServingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
