"""TenantManager — N models served from ONE shared storage backend.

The multi-tenant shape of GPU-specialized recommendation serving (HugeCTR
inference parameter server, arxiv 2210.08804): several differently-sized
DLRMs co-resident on one accelerator, their embedding tables living in a
single shared cache hierarchy, with one DEVICE BYTE BUDGET arbitrated
across them rather than statically partitioned per model.

The manager composes pieces that already exist, per tenant:

  * the shared backend is built ONCE with `tenants={name: table_count}`
    (sharded/pool), every tenant's table stack concatenated along the
    table axis — tenant-pure units, namespace-local columns;
  * each tenant model's collection is re-bound to a `TenantStorage` view,
    so an UNCHANGED `ServingSession` per tenant drives batching, engines,
    refresh, auto-tuning, and its own SLO ladder against its slice only;
  * one `BudgetArbiter` (repro_torch.ps.tuning) sits above the sessions,
    re-splitting hot/warm capacity and prefetch depth across tenants
    from each tenant's live access-count deltas — the fairness mechanism
    that contains a flash-crowd tenant (`multi_tenant` bench invariant).

Scheduling: `poll()` executes at most ONE tenant batch per call.
`"fair"` rotates round-robin over tenants with queued work, so a busy
neighbor cannot monopolize the serving loop; `"fifo"` always serves the
oldest queued head — globally arrival-ordered, which is exactly the
noisy-neighbor baseline the bench's arbiter-off leg measures.

Single-tenant degenerate case: one spec behaves like a plain
`ServingSession` (flat `percentiles()`, same knobs), so the tenant-aware
API is a strict superset, not a fork.

A port of `repro/serving/tenants.py`. Where it differs: a `TenantSpec`
carries no params (a port model holds its weights), each tenant's tables
are brought to the host once to build the shared backend, and the union
collection lives on the tenants' device (with `backend="pool"`, so do the
worker processes' units).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.ps.tuning import ArbiterConfig, AutoTuneConfig, BudgetArbiter
from repro_torch.serving.config import ServingControllers, resolve_controllers
from repro_torch.serving.server import BatcherConfig, Query
from repro_torch.serving.session import ServingSession
from repro_torch.serving.slo import SLOConfig
from repro_torch.storage.tenancy import TenantStorage


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a model with an `.ebc` (tenant-local geometry: its own
    table count and pooling factor, its own weights), and optional
    per-tenant overrides of the manager-wide batcher/controllers."""
    name: str
    model: Any
    batcher: Optional[BatcherConfig] = None
    controllers: Optional[ServingControllers] = None


def _tenant_tables(spec: TenantSpec) -> np.ndarray:
    """The tenant's [T, R, D] table stack, brought to the host once (a
    host-backed collection's tables are there already: no copy)."""
    ebc = spec.model.ebc
    return ebc.tables[:ebc.cfg.num_tables].detach().cpu().numpy()


class TenantManager:
    """Owns the shared backend + one `ServingSession` per tenant + the
    cross-tenant arbiter. `**build_opts` go to the shared backend's
    `build()` verbatim (`ps_cfg=`, `trace=`, `num_shards=`/`num_workers=`,
    ...); tenant table stacks are concatenated in spec order, matching the
    contiguous namespaces `tenants={...}` carves."""

    def __init__(self, specs: list, *, backend: str = "sharded",
                 batcher: Optional[BatcherConfig] = None,
                 sla_ms: float = 50.0,
                 refresh_every_batches: int = 0,
                 async_refresh: bool = False,
                 auto_tune: Union[AutoTuneConfig, bool, None] = None,
                 slo: Optional[SLOConfig] = None,
                 controllers: Optional[ServingControllers] = None,
                 scheduling: str = "fair",
                 clock: Optional[Callable] = None,
                 warmup: bool = True,
                 **build_opts):
        if not specs:
            raise ValueError("TenantManager needs at least one TenantSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        if scheduling not in ("fair", "fifo"):
            raise ValueError("scheduling must be 'fair' or 'fifo'")
        self._check_geometry(specs)
        base = resolve_controllers(controllers, auto_tune, slo,
                                   where="TenantManager")
        self._arbiter_cfg = base.arbiter
        self._tenant_base = dataclasses.replace(base, arbiter=None)
        self.scheduling = scheduling
        self.clock = clock
        self._session_opts = dict(batcher=batcher, sla_ms=sla_ms,
                                  refresh_every_batches=refresh_every_batches,
                                  async_refresh=async_refresh,
                                  warmup=warmup)
        # ONE shared backend over the concatenated table axis; pooling is
        # per-tenant (tenant_lookup pools by each batch's own L), so the
        # union cfg's pooling is just a placeholder. The union collection
        # adopts the concatenated host tables and lives on the tenants'
        # device (pooled output lands there)
        first = specs[0].model.ebc.cfg
        stacks = [_tenant_tables(s) for s in specs]
        counts = {s.name: t.shape[0] for s, t in zip(specs, stacks)}
        union_cfg = dataclasses.replace(
            first, num_tables=sum(counts.values()), storage=backend)
        union = torch.from_numpy(np.concatenate(stacks, axis=0))
        del stacks
        self._union_ebc = EmbeddingBagCollection(
            union_cfg, device=specs[0].model.ebc.device, tables=union)
        self.shared = self._union_ebc.storage
        self.shared.build(tenants=counts, **build_opts)
        self._specs: dict[str, TenantSpec] = {}
        self._sessions: dict[str, ServingSession] = {}
        self.views: dict[str, TenantStorage] = {}
        self._closed = False
        self.last_polled: Optional[str] = None
        self._rr = 0
        try:
            for spec in specs:
                self._bind(spec)
        except Exception:
            self.close()
            raise
        # created AFTER every session's warmup reset, so the arbiter's
        # first demand window starts from clean per-tenant counters
        self.arbiter: Optional[BudgetArbiter] = (
            BudgetArbiter(self._arbiter_cfg, self.views)
            if self._arbiter_cfg is not None else None)

    @staticmethod
    def _check_geometry(specs: list) -> None:
        """Tenants share one table AXIS, so row count / dim / dtype /
        combine must agree; table count and pooling are per-tenant."""
        first = specs[0].model.ebc.cfg
        for s in specs[1:]:
            c = s.model.ebc.cfg
            got = (c.rows, c.dim, c.dtype, c.combine)
            want = (first.rows, first.dim, first.dtype, first.combine)
            if got != want:
                raise ValueError(
                    f"tenant {s.name!r} geometry {got} does not match "
                    f"{specs[0].name!r} {want} — tenants share one "
                    "(rows, dim, dtype, combine) table axis")

    def _bind(self, spec: TenantSpec) -> None:
        """Rebind the tenant model's collection to its view and stand up
        its (completely standard) session."""
        ctrl = (spec.controllers if spec.controllers is not None
                else self._tenant_base)
        if ctrl.arbiter is not None:
            raise ValueError(
                f"tenant {spec.name!r} sets a per-tenant arbiter; the "
                "arbiter is the MANAGER's controller (it splits the one "
                "shared budget) — pass it via TenantManager(controllers=)")
        view = TenantStorage(self.shared, spec.name, ebc=spec.model.ebc)
        spec.model.ebc.storage = view
        self._sessions[spec.name] = ServingSession(
            spec.model, controllers=ctrl, clock=self.clock,
            **{**self._session_opts,
               "batcher": spec.batcher or self._session_opts["batcher"]})
        self._specs[spec.name] = spec
        self.views[spec.name] = view

    # -- serving loop --------------------------------------------------------
    @property
    def names(self) -> list:
        return list(self._sessions)

    def session(self, name: str) -> ServingSession:
        return self._sessions[name]

    def submit(self, name: str, query: Query) -> None:
        self._sessions[name].submit(query)

    def submit_batch(self, name: str, dense: np.ndarray,
                     indices: np.ndarray, qid0: Optional[int] = None) -> int:
        return self._sessions[name].submit_batch(dense, indices, qid0)

    def _order(self) -> list:
        """Tenants to try this poll, scheduling-ordered; only tenants
        with queued work are candidates."""
        ready = [n for n in self._sessions
                 if self._sessions[n].server.batcher.queue]
        if not ready:
            return []
        if self.scheduling == "fifo":
            return sorted(ready, key=lambda n: self._sessions[n]
                          .server.batcher.queue[0].arrival_s)
        names = list(self._sessions)
        k = self._rr % len(names)
        self._rr += 1
        rotated = names[k:] + names[:k]
        return [n for n in rotated if n in set(ready)]

    def poll(self, force: bool = False) -> int:
        """Execute at most ONE tenant batch (the scheduler picks whose).
        Every executed batch steps the arbiter, with SLO-engaged tenants
        flagged so their depth knob is left to the breach handler."""
        for name in self._order():
            served = self._sessions[name].poll(force=force)
            if served:
                self.last_polled = name
                if self.arbiter is not None:
                    engaged = {n for n, s in self._sessions.items()
                               if s.slo is not None and s.slo.engaged}
                    self.arbiter.step(engaged=engaged)
                return served
        self.last_polled = None
        return 0

    def drain(self, timeout_s: float = 10.0) -> None:
        while any(s.server.batcher.queue for s in self._sessions.values()):
            if not self.poll(force=True):
                break

    # -- elastic tenancy -----------------------------------------------------
    def add_tenant(self, spec: TenantSpec, *, trace=None) -> None:
        """Admit a tenant mid-serving (sharded backend; the pool's static
        tenancy raises from `attach_tenant`). Sibling tenants keep serving
        bit-exactly throughout — attach is append-only."""
        if spec.name in self._sessions:
            raise ValueError(f"tenant {spec.name!r} already attached")
        self._check_geometry([self._specs[next(iter(self._specs))], spec]
                             if self._specs else [spec])
        self.shared.attach_tenant(spec.name, _tenant_tables(spec),
                                  trace=trace)
        try:
            self._bind(spec)
        except Exception:
            self.shared.detach_tenant(spec.name)
            raise
        if self.arbiter is not None:
            view = self.views[spec.name]
            self.arbiter.views[spec.name] = view
            self.arbiter._last[spec.name] = self.arbiter._accesses(view)

    def remove_tenant(self, name: str) -> None:
        """Retire a tenant mid-serving: its session closes (the tenant
        view's `close()` is a no-op — the backend stays up), then the
        backend releases its units."""
        sess = self._sessions.pop(name)
        self._specs.pop(name)
        self.views.pop(name)
        if self.arbiter is not None:
            self.arbiter.views.pop(name, None)
            self.arbiter._last.pop(name, None)
        sess.close()
        self.shared.detach_tenant(name)

    # -- reporting -----------------------------------------------------------
    def percentiles(self) -> dict:
        """Tenant-scoped report: `{"tenants": {name: session report},
        "shared": arbiter + scheduling}`. With ONE tenant the flat session
        report comes back directly (degenerate case — drop-in for a plain
        session's callers)."""
        per = {n: s.percentiles() for n, s in self._sessions.items()}
        shared = {"num_tenants": len(per), "scheduling": self.scheduling}
        if self.arbiter is not None:
            shared.update(self.arbiter.summary())
        if len(per) == 1:
            out = dict(next(iter(per.values())))
            out.update(shared)
            return out
        return {"tenants": per, "shared": shared}

    def stats(self) -> dict:
        """The shared backend's tenant-shaped storage stats (cache
        counters), as distinct from `percentiles()`'s latency report."""
        return self.shared.stats()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            for sess in self._sessions.values():
                sess.close()         # tenant views: storage close no-ops
        finally:
            self.shared.close()      # the ONE owner of the backend

    def __enter__(self) -> "TenantManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
