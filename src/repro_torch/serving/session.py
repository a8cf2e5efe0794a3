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
  * **lifecycle** — warmup runs the engine on a zero batch at every batch
    size the session can serve (building the kernels) then `flush()` +
    `reset_stats()` so synthetic traffic never pollutes the caches or
    counters; `close()` installs an in-flight refresh plan, stops the
    refresh helper and closes the storage.
  * **controllers** — `auto_tune=` (`ps.tuning.AutoTuner`), `slo=`
    (`serving.slo.SLOController`) or the one spec that holds both and
    online updates, `controllers=serving.configure(...)`, all stepped
    from `poll()` after each executed batch; `clock=` puts the loop on
    trace time for `repro_torch.traffic.replay`.

Typical use:

    model = DLRM(cfg, device="cuda")        # cfg.embedding.storage="device"
    with ServingSession(model, batcher=BatcherConfig(max_batch=2048)) as s:
        s.submit_batch(dense, indices); s.drain()
        print(s.percentiles())

Only the multi-tenant arbiter is refused (`controllers=` with an
`arbiter` is a `ValueError`: a single session has nothing to arbitrate).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.ps.tuning import AutoTuneConfig, AutoTuner
from repro_torch.serving.config import ServingControllers, resolve_controllers
from repro_torch.serving.server import (BatcherConfig, InferenceServer, Query,
                                        QueryShedError)
from repro_torch.serving.slo import SLOConfig, SLOController
from repro_torch.storage import require_capability


class ServingSession:
    """Owns batcher + engine + storage for one model."""

    def __init__(self, model, *,
                 batcher: Optional[BatcherConfig] = None,
                 sla_ms: float = 50.0,
                 refresh_every_batches: int = 0,
                 async_refresh: bool = False,
                 auto_tune: Union[AutoTuneConfig, bool, None] = None,
                 slo: Optional[SLOConfig] = None,
                 controllers: Optional[ServingControllers] = None,
                 clock: Optional[Callable] = None,
                 warmup: bool = True):
        # auto_tune=/slo= are exact aliases for controllers=configure(...)
        # — one surface per call, never both (ValueError)
        spec = resolve_controllers(controllers, auto_tune, slo,
                                   where="ServingSession")
        if spec.arbiter is not None:
            raise ValueError(
                "the arbiter re-splits shared capacity ACROSS tenants; a "
                "single-model ServingSession has nothing to arbitrate — "
                "it comes with the tenant manager (ROADMAP.md Queue 1 "
                "item 11)")
        auto_tune, slo = spec.auto_tune, spec.slo
        self.model = model
        self.storage = model.ebc.storage
        self.clock = clock
        caps = self.storage.capabilities()
        # online model updates (epoch guard): every admitted query is
        # pinned to the version current at its admission, and the stream
        # is polled between batches — see _apply_updates for the barrier.
        # `device` commits write the model's own tables in place, so the
        # engine (which reads them on every call) needs no rebinding.
        self._updates = spec.updates
        self._model_version = 0
        self._updates_applied = 0
        self._updates_delta = 0
        self._updates_full = 0
        self._updates_rolled_back = 0
        self._update_stall_s = 0.0
        self._update_batches = 0
        self._pending_updates: list = []
        self._qid_versions: dict[int, int] = {}
        if self._updates is not None:
            require_capability(self.storage, "updatable")
            self._model_version = self.storage.version()
        if (async_refresh or refresh_every_batches) and not caps.refreshable:
            # fail fast instead of silently never re-pinning
            require_capability(self.storage, "refreshable")
        batcher = batcher if batcher is not None else BatcherConfig()
        if (slo is not None and slo.shed_deadline_frac > 0
                and batcher.deadline_ms == 0):
            # an SLO without admission control cannot hold its target —
            # the backlog's queueing delay alone blows it. Default the
            # deadline budget to the target unless the caller configured
            # (or explicitly zeroed) one.
            batcher = dataclasses.replace(
                batcher,
                deadline_ms=slo.target_p99_ms * slo.shed_deadline_frac)
        self.server = InferenceServer(
            self._build_engine(caps), batcher, sla_ms=sla_ms,
            storage=self.storage,
            refresh_every_batches=refresh_every_batches,
            async_refresh=async_refresh, clock=clock)
        self._forward = self.server.forward
        self._closed = False
        self._next_qid = 0
        if warmup:
            sizes = [batcher.max_batch]
            if slo is not None and slo.min_batch > 0:
                # the shrink rung re-sizes the batch quantum mid-overload;
                # run every rung's shape now so engaging the ladder never
                # stalls a breached window on a first launch at that shape
                b = batcher.max_batch
                while b > slo.min_batch:
                    b = max(slo.min_batch, b // 2)
                    sizes.append(b)
            self._warmup(sizes)
        # runtime auto-tuning (queue depth / tier capacity): driven from
        # poll() through protocol verbs only. Backends that do not report
        # `tunable` (device) leave the tuner permanently inert. Created
        # AFTER warmup: the tuner's first counter snapshot must postdate
        # the warmup stats reset or the first window sees negative deltas.
        # (`resolve_controllers` already turned auto_tune=True into a
        # default AutoTuneConfig.)
        self.tuner: Optional[AutoTuner] = (
            AutoTuner(auto_tune, self.storage) if auto_tune else None)
        # SLO outer loop: windowed-p99 watcher + overload escalation
        # ladder. Also created after warmup, handed the tuner so it can
        # suspend the queue-depth leg while engaged, and the live Batcher
        # so the shrink rung (min_batch > 0) can re-size it.
        self.slo: Optional[SLOController] = (
            SLOController(slo, self.storage, self.server.stats,
                          tuner=self.tuner, batcher=self.server.batcher)
            if slo is not None else None)

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

    def _warmup(self, batch_sizes) -> None:
        """Run the engine on a zero batch per armed batch size (the kernel
        builds and loads on its first launch), then drop the synthetic
        traffic's footprint and its counters so measurements start
        clean."""
        cfg = self.model.cfg
        for batch in batch_sizes:
            dense = np.zeros((batch, cfg.dense_features), np.float32)
            idx = np.zeros((batch, cfg.embedding.num_tables,
                            cfg.embedding.pooling), np.int32)
            self._forward(dense, idx).cpu()
        self.storage.flush()
        self.storage.reset_stats()

    # -- serving loop (delegation) ------------------------------------------
    def submit(self, query: Query) -> None:
        self.server.submit(query)
        # admission is the pin point: the query is guaranteed to be served
        # by THIS version (the commit barrier drains it before any swap).
        # A shed query raises above and is never pinned.
        if self._updates is not None:
            self._qid_versions[query.qid] = self._model_version
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
                if self._updates is not None:
                    self._qid_versions[qid0 + i] = self._model_version
            except QueryShedError:
                pass            # tallied in stats by the server
        self._next_qid = qid0 + len(dense)
        return admitted

    def poll(self, force: bool = False) -> int:
        served = self.server.poll(force=force)
        if served:
            # SLO first: it publishes depth ownership (suspension) before
            # the tuner decides whether its depth leg may fire this batch
            if self.slo is not None:
                self.slo.step()
            if self.tuner is not None:
                self.tuner.step()   # one executed batch per serving poll
            if self._updates is not None:
                self._update_batches += 1
                if self._update_batches \
                        % self._updates.poll_every_batches == 0:
                    self._apply_updates()
        return served

    # -- online model updates ------------------------------------------------
    def version_of(self, qid: int) -> Optional[int]:
        """The model version `qid` was pinned to at admission (None when
        updates are not armed or the qid was never admitted). The epoch
        guard guarantees the response for `qid` is computed from this
        version's tables."""
        return self._qid_versions.get(qid)

    def _apply_updates(self) -> None:
        """Poll the update stream; publish any new versions behind the
        epoch guard. Runs between batches on the serving thread.

        The commit barrier comes first: every queued query was admitted —
        and pinned — under the CURRENT version, so they are force-served
        through the raw server poll (no recursion into this hook) before
        any tier takes new bytes. Only then do the records apply, in
        version order, through the storage update transaction. A commit
        that reports no update leaves the record pending for the next
        poll — versions never apply out of order, and the stream cursor
        is never replayed."""
        records = self._pending_updates \
            + list(self._updates.stream.poll())
        self._pending_updates = []
        if not records:
            return
        t0 = time.perf_counter()
        deadline = t0 + self._updates.drain_timeout_s
        while self.server.batcher.queue and time.perf_counter() < deadline:
            self.server.poll(force=True)
        for i, rec in enumerate(records):
            v = int(rec["version"])
            self.storage.begin_update(v)
            for t, (rows, vals) in rec["tables"].items():
                self.storage.apply_update(int(t), rows, vals)
            res = self.storage.commit_update(v)
            if not res.get("updated"):
                self._updates_rolled_back += 1
                self._pending_updates = records[i:]
                break
            self._model_version = v
            self._updates_applied += 1
            if rec.get("kind") == "delta":
                self._updates_delta += 1
            else:
                self._updates_full += 1
        # the device writes of a commit are part of the stall
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        self._update_stall_s += time.perf_counter() - t0

    def drain(self, timeout_s: float = 10.0) -> None:
        """`InferenceServer.drain` routed through `self.poll` so the
        controllers see drain-phase batches too (same force-flush law)."""
        self.server.drain(timeout_s=timeout_s, poll=self.poll)

    # -- reporting ----------------------------------------------------------
    @property
    def stats(self):
        return self.server.stats

    def percentiles(self) -> dict:
        """Latency percentiles + whatever counters the bound backend
        reports; each running controller's summary rides along (the
        tuner's `prefetch_depth`, the SLO's `slo_level`, the update
        stream's `model_version` and `update_stall_s`)."""
        out = self.server.stats.percentiles()
        if self.tuner is not None and out:
            out.update(self.tuner.summary())
        if self.slo is not None and out:
            out.update(self.slo.summary())
        if self._updates is not None and out:
            out["model_version"] = self._model_version
            out["updates_applied"] = self._updates_applied
            out["updates_delta"] = self._updates_delta
            out["updates_full"] = self._updates_full
            out["updates_rolled_back"] = self._updates_rolled_back
            out["update_stall_s"] = float(self._update_stall_s)
        return out

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
