"""End-to-end driver: serve a DLRM with batched requests on the port.

Streams queries across the paper's hotness spectrum through the batching
inference server and reports per-hotness latency percentiles — the
port's counterpart of the JAX package's `examples/serve_dlrm.py`.

The storage backend comes from the `repro_torch.storage` registry:
`device` (tables in device memory, pooled by the CUDA embedding-bag
kernel), `tiered` (hot block and warm cache on the device, cold tier on
the host, hits pooled by the fused lookup kernel) or `sharded` (the
tiered store split table-wise over `--shards` shard workers, one fused
launch a unit; `--placement balanced` plans the split from the trace and
`--migrate-every N` re-plans it live).

`--tenants N` serves N DLRMs over ONE shared sharded backend
(`TenantManager` with the fair-share arbiter), their traffic merged on
one virtual clock by `replay_tenants`.

`--update-every N` arms zero-downtime online model updates: a
trainer-side `ModelUpdateStream` publishes a delta touching
`--update-rows FRAC` of one table's rows every N batches, and the session
installs each version between batches behind the epoch guard.

`--trace` switches to timestamped-trace replay (`repro_torch.traffic`):
queries arrive on a virtual clock following a named rate profile at a
rate calibrated to the measured service rate, so "overload" means the
same thing on any card. `--slo-p99-ms` arms the SLO controller on top
(deadline admission, the widen -> shrink (`--min-batch`) -> degrade
ladder). The run ends with a shed/degraded summary.

    python -m repro_torch.examples.serve_dlrm [--queries 256]
    python -m repro_torch.examples.serve_dlrm --storage tiered
    python -m repro_torch.examples.serve_dlrm --storage tiered \\
        --trace flash --slo-p99-ms 20 --min-batch 8
    python -m repro_torch.examples.serve_dlrm --storage tiered \\
        --update-every 4 --update-rows 0.02
    python -m repro_torch.examples.serve_dlrm --storage sharded --shards 4 \\
        --placement balanced --migrate-every 8
    python -m repro_torch.examples.serve_dlrm --tenants 2
    python -m repro_torch.examples.serve_dlrm --device cpu --rows 5000 \\
        --queries 64 --batch 16 --hotness med_hot

`--device cuda` (the default) runs the kernels and needs a card; `--device
cpu` runs their plain versions. Run from a checkout with `src` on the
path (`PYTHONPATH=src`).
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import ModelUpdateStream
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import AutoTuneConfig, PSConfig
from repro_torch.serving import (ArbiterConfig, BatcherConfig,
                                 ServingSession, SLOConfig, TenantManager,
                                 TenantSpec, UpdateConfig, configure)
from repro_torch.traffic import (VirtualClock, make_traffic, replay,
                                 replay_tenants)

HOTNESS = ("one_item", "high_hot", "med_hot", "low_hot", "random")
DIM = 128
# the backend of the JAX package that the port has not reached
NOT_PORTED = {"pool": "ROADMAP.md Queue 1 item 10"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--tables", type=int, default=8)
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--pooling", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; needs a card) or cpu (their "
                         "plain versions)")
    ap.add_argument("--storage",
                    choices=("device", "tiered", "sharded", "pool"),
                    default="device",
                    help="storage backend (repro_torch.storage registry)")
    ap.add_argument("--shards", type=int, default=2,
                    help="sharded: table-wise shard workers")
    ap.add_argument("--workers", type=int, default=0,
                    help="pool: worker processes (not ported yet)")
    ap.add_argument("--placement", choices=("contiguous", "balanced"),
                    default="contiguous",
                    help="sharded: table-to-shard assignment — contiguous "
                         "split or frequency-aware LPT balancing from the "
                         "trace (prints the shard load table)")
    ap.add_argument("--hot-rows", type=int, default=2500,
                    help="tiered/sharded: device-pinned rows per table")
    ap.add_argument("--warm-slots", type=int, default=2500,
                    help="tiered/sharded: warm-cache slots per table")
    ap.add_argument("--refresh-every", type=int, default=8,
                    help="tiered/sharded: re-pin the hot set every N "
                         "batches")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="tiered/sharded: threaded prefetch + helper-thread "
                         "hot-set re-planning")
    ap.add_argument("--auto-tune", action="store_true",
                    help="runtime queue-depth auto-tuning (tiered/sharded; "
                         "inert on device)")
    ap.add_argument("--migrate-every", type=int, default=0,
                    help="sharded: re-plan table placement from the live "
                         "traffic window every N batches and swap it in "
                         "past --migrate-threshold (0 = off)")
    ap.add_argument("--migrate-threshold", type=float, default=1.25,
                    help="live imbalance ratio that justifies a "
                         "mid-serving placement migration")
    ap.add_argument("--hotness", choices=HOTNESS + ("all",), default="all",
                    help="run one hotness level or the sweep")
    ap.add_argument("--update-every", type=int, default=0,
                    help="publish a delta every N batches and install it "
                         "mid-serving behind the epoch guard (0 = off)")
    ap.add_argument("--update-rows", type=float, default=0.01,
                    help="fraction of one table's rows each delta touches")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve N tenant DLRMs over ONE shared sharded "
                         "backend (TenantManager + fair-share arbiter; 0 = "
                         "single-tenant modes)")
    ap.add_argument("--trace", choices=("steady", "diurnal", "flash",
                                        "shift"), default=None,
                    help="replay a timestamped trace on a virtual clock "
                         "instead of the hotness sweep")
    ap.add_argument("--slo-p99-ms", type=float, default=0.0,
                    help="trace mode: arm the SLO controller with this "
                         "windowed-p99 target (0 = off)")
    ap.add_argument("--min-batch", type=int, default=0,
                    help="trace mode with an SLO: floor of the batch-shrink "
                         "rung (0 = no shrink rung)")
    ap.add_argument("--base-qps", type=float, default=0.0,
                    help="trace mode: offered base rate (0 = 0.5x the "
                         "measured service rate)")
    args = ap.parse_args(argv)
    if args.storage in NOT_PORTED or args.workers:
        ap.error(f"--storage pool and --workers are not ported yet: "
                 f"{NOT_PORTED['pool']}")
    if args.slo_p99_ms and not (args.trace or args.tenants):
        ap.error("--slo-p99-ms needs --trace: the SLO controller watches "
                 "windowed p99 over a timestamped replay")
    return args


def build_model(args, hotness: str):
    """A DLRM with random weights on `--device`, its tiered or sharded
    storage built from a trace of another seed's queries."""
    cfg = DLRMConfig(embedding=EmbeddingStageConfig(
        num_tables=args.tables, rows=args.rows, dim=DIM,
        pooling=args.pooling, storage=args.storage))
    model = DLRM(cfg, device=args.device, seed=0)
    caps = model.ebc.storage.capabilities()
    if not caps.device_resident:
        trace = make_traffic("steady", base_qps=1.0, num_tables=args.tables,
                             rows=args.rows, pooling=args.pooling,
                             hotness=hotness, seed=1).queries(2 * args.batch)
        kw = {}
        if caps.shardable:
            kw = dict(num_shards=args.shards, placement=args.placement)
        model.ebc.storage.build(
            ps_config(args), trace=np.stack([q.indices for q in trace]),
            **kw)
        placement = getattr(model.ebc.storage, "placement", None)
        if placement is not None:
            # the planner's shard load table (estimated from the trace)
            print(placement.describe(), flush=True)
    return model


def ps_config(args) -> PSConfig:
    return PSConfig(hot_rows=args.hot_rows, warm_slots=args.warm_slots,
                    prefetch_depth=2, window_batches=16,
                    async_prefetch=args.async_mode, warm_backing="device",
                    fused_lookup=True)


def _sync(model) -> None:
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def run_session(args, hotness: str) -> dict:
    """The hotness sweep: batches of one hotness level through a session,
    with online updates when armed."""
    model = build_model(args, hotness)
    device_resident = model.ebc.storage.capabilities().device_resident
    queries = make_traffic("steady", base_qps=1.0, num_tables=args.tables,
                           rows=args.rows, pooling=args.pooling,
                           hotness=hotness, seed=0).queries(args.queries)
    dense = np.stack([q.dense for q in queries])
    idx = np.stack([q.indices for q in queries])
    auto_tune = (AutoTuneConfig(
        depth_every_batches=8 if args.auto_tune else 0,
        migrate_every_batches=args.migrate_every,
        migrate_threshold=args.migrate_threshold)
        if (args.auto_tune or args.migrate_every) else None)
    pub = upd_dir = updates = None
    if args.update_every:
        # trainer side: a publisher stream over a scratch version root;
        # the session consumes it through the epoch-guarded UpdateConfig
        upd_dir = tempfile.TemporaryDirectory()
        pub = ModelUpdateStream(upd_dir.name)
        pub.publish_full(model.ebc.tables[:args.tables])
        updates = UpdateConfig(stream=ModelUpdateStream(upd_dir.name))
        rng_u = np.random.default_rng(1)
    try:
        with ServingSession(
                model,
                batcher=BatcherConfig(max_batch=args.batch, max_wait_s=0.0),
                sla_ms=500,
                refresh_every_batches=(0 if device_resident
                                       else args.refresh_every),
                async_refresh=args.async_mode and not device_resident,
                controllers=configure(auto_tune=auto_tune,
                                      updates=updates)) as sess:
            # keep one batch queued ahead of the executing one so staging
            # sees the full next batch and prefetch overlap fires
            n_batch = 0
            for lo in range(0, args.queries, args.batch):
                sess.submit_batch(dense[lo:lo + args.batch],
                                  idx[lo:lo + args.batch], qid0=lo)
                n_batch += 1
                if lo:
                    sess.poll()
                if pub is not None and n_batch % args.update_every == 0:
                    t = (n_batch // args.update_every - 1) % args.tables
                    n = max(1, int(args.update_rows * args.rows))
                    rows = rng_u.choice(args.rows, size=n, replace=False)
                    pub.publish_delta({t: (rows, rng_u.normal(
                        size=(n, DIM)).astype(np.float32))})
            sess.drain()
        pct, viol = sess.percentiles(), sess.sla_violations()
        if device_resident:
            # embedding-stage share of a batch (paper Fig. 1)
            ids = torch.from_numpy(idx[:args.batch]).to(model.device)
            with torch.inference_mode():
                model.embedding_only(ids)
                _sync(model)
                t0 = time.perf_counter()
                model.embedding_only(ids)
                _sync(model)
            pct["emb_share"] = (time.perf_counter() - t0) / max(
                pct["mean_batch_ms"] / 1e3, 1e-9)
        pct["sla_violations"] = viol
        return pct
    finally:
        if upd_dir is not None:
            upd_dir.cleanup()


def format_line(hotness: str, pct: dict) -> str:
    line = (f"{hotness:9s} served={pct['served']:4d} "
            f"p50={pct['p50_ms']:.1f}ms p99={pct['p99_ms']:.1f}ms "
            f"batch={pct['mean_batch_ms']:.1f}ms "
            f"sla_viol={pct['sla_violations']}")
    if "cache_hit_rate" in pct:
        line += (f" hit={pct['cache_hit_rate']:.2f} "
                 f"(hot={pct['hot_hit_rate']:.2f} "
                 f"warm={pct['warm_hit_rate']:.2f}) "
                 f"evict={pct['evictions']} refresh={pct['refreshes']} "
                 f"off_crit={pct['off_critical_frac']:.2f}")
        if "prefetch_depth" in pct:
            line += (f" depth={pct['prefetch_depth']} "
                     f"(retunes={pct['depth_retunes']})")
    else:
        line += f" emb_share~{min(pct['emb_share'], 1.0):.0%}"
    if "model_version" in pct:
        line += (f" v={pct['model_version']} "
                 f"updates={pct['updates_applied']}"
                 f"(d={pct['updates_delta']} f={pct['updates_full']} "
                 f"rb={pct['updates_rolled_back']}) "
                 f"stall={pct['update_stall_s'] * 1e3:.1f}ms")
    return line


def run_trace(args) -> list[str]:
    """Timestamped-trace replay: deterministic offered load on a virtual
    clock, real measured service cost, optional SLO controller. Returns
    the timeline excerpt and the shed/degraded summary lines."""
    model = build_model(args, "med_hot")
    device_resident = model.ebc.storage.capabilities().device_resident
    slo = (SLOConfig(target_p99_ms=args.slo_p99_ms, min_batch=args.min_batch)
           if args.slo_p99_ms else None)
    sess = ServingSession(
        model,
        batcher=BatcherConfig(max_batch=args.batch, max_wait_s=0.002),
        sla_ms=500,
        refresh_every_batches=(0 if device_resident
                               else args.refresh_every),
        async_refresh=args.async_mode and not device_resident,
        slo=slo, clock=VirtualClock())
    try:
        # calibrate the real batch service time so the offered load is a
        # known multiple of what this device can serve; the probe batches
        # are not traffic — drop their cache footprint like warmup does
        cfg = model.cfg
        dense = np.zeros((args.batch, cfg.dense_features), np.float32)
        idx = np.zeros((args.batch, args.tables, args.pooling), np.int32)
        t0 = time.perf_counter()
        for _ in range(3):
            sess._forward(dense, idx).cpu()
        t_b = (time.perf_counter() - t0) / 3
        sess.storage.flush()
        sess.storage.reset_stats()
        svc_qps = args.batch / t_b
        base = args.base_qps or 0.5 * svc_qps
        kw = dict(base_qps=base, num_tables=args.tables, rows=args.rows,
                  pooling=args.pooling, seed=0)
        if args.trace == "flash":
            kw.update(spike_qps=4.0 * svc_qps, spike_start_s=8.0 * t_b,
                      spike_len_s=24.0 * t_b)
        elif args.trace == "diurnal":
            kw.update(period_s=args.queries / base, amplitude=0.5)
        elif args.trace == "shift":
            kw.update(shift_at_s=0.5 * args.queries / base)
        gen = make_traffic(args.trace, **kw)
        window = max(32, min(256, args.queries // 2))
        rep = replay(sess, gen.queries(args.queries), window_queries=window)
        reasons = dict(sess.stats.shed_reasons)
    finally:
        sess.close()
    lines = [f"trace={args.trace} base_qps={base:.0f} "
             f"({base / svc_qps:.2f}x service rate) "
             f"slo={'off' if slo is None else f'{args.slo_p99_ms:g}ms'}",
             "    t_ms  served   shed  qlen  wp99_ms  lvl  degraded"]
    step = max(1, len(rep.timeline) // 8)
    picks = list(rep.timeline[::step])
    if rep.timeline and picks[-1] is not rep.timeline[-1]:
        picks.append(rep.timeline[-1])
    for s in picks:
        lines.append(f"{s.t_s * 1e3:8.1f} {s.served:7d} {s.shed:6d} "
                     f"{s.queue_len:5d} {s.windowed_p99_ms:8.2f} "
                     f"{s.slo_level:4d} {'yes' if s.degraded else 'no':>9s}")
    pct = rep.percentiles
    line = (f"submitted={rep.submitted} admitted={rep.admitted} "
            f"served={rep.served} shed={rep.shed} "
            f"(frac={rep.shed_frac:.3f}"
            + (f", {reasons}" if reasons else "") + ") "
            f"final_wp99={rep.final_windowed_p99_ms() or 0.0:.2f}ms")
    if slo is not None:
        line += (f" breaches={pct.get('slo_breaches', 0)} "
                 f"shrinks={pct.get('slo_batch_shrinks', 0)} "
                 f"degraded_batches={pct.get('slo_degraded_batches', 0)}")
    lines.append(line)
    return lines


def run_tenants(args) -> list[str]:
    """Multi-tenant serving: `--tenants` DLRMs over ONE shared sharded
    backend. Each tenant gets its own steady stream; `replay_tenants`
    merges them on one virtual clock through the manager's fair
    scheduler, and the arbiter re-splits the device budget and prefetch
    depth from live per-tenant load. Returns one line per tenant and the
    shared-backend summary."""
    specs = []
    for t in range(args.tenants):
        # same rows/dim (the shared axis), per-tenant pooling
        cfg = DLRMConfig(embedding=EmbeddingStageConfig(
            num_tables=args.tables, rows=args.rows, dim=DIM,
            pooling=max(2, args.pooling - 2 * t), storage="sharded"))
        specs.append(TenantSpec(name=f"t{t}", model=DLRM(
            cfg, device=args.device, seed=t)))
    slo = (SLOConfig(target_p99_ms=args.slo_p99_ms,
                     min_batch=max(2, args.batch // 8))
           if args.slo_p99_ms else None)
    mgr = TenantManager(
        specs, backend="sharded",
        batcher=BatcherConfig(max_batch=args.batch, max_wait_s=0.002),
        sla_ms=500, refresh_every_batches=args.refresh_every,
        controllers=configure(slo=slo, arbiter=ArbiterConfig(
            every_batches=8, budget_fallback_bytes=64 << 20)),
        scheduling="fair", clock=VirtualClock(), ps_cfg=ps_config(args),
        num_shards=args.shards)
    try:
        # calibrate offered load to the measured shared service rate; the
        # probe batches are not traffic
        first = mgr.session(mgr.names[0])
        cfg = specs[0].model.cfg
        dense = np.zeros((args.batch, cfg.dense_features), np.float32)
        idx = np.zeros((args.batch, args.tables, cfg.embedding.pooling),
                       np.int32)
        t0 = time.perf_counter()
        for _ in range(3):
            first._forward(dense, idx).cpu()
        t_b = (time.perf_counter() - t0) / 3
        first.storage.flush()
        first.storage.reset_stats()
        svc_qps = args.batch / t_b
        per_tenant = (args.base_qps or 0.5 * svc_qps) / args.tenants
        streams = {
            spec.name: make_traffic(
                "steady", base_qps=per_tenant,
                dense_features=spec.model.cfg.dense_features,
                num_tables=args.tables, rows=args.rows,
                pooling=spec.model.cfg.embedding.pooling,
                seed=t).queries(args.queries // args.tenants)
            for t, spec in enumerate(specs)}
        reports = replay_tenants(mgr, streams)
        pct, st = mgr.percentiles(), mgr.stats()
    finally:
        mgr.close()
    lines = [f"tenants={args.tenants} backend=sharded "
             f"per_tenant_qps={per_tenant:.0f} "
             f"({args.tenants * per_tenant / svc_qps:.2f}x service rate)"]
    per = pct["tenants"] if "tenants" in pct else {mgr.names[0]: pct}
    for name, tp in per.items():
        rep = reports[name]
        lines.append(f"  {name}: submitted={rep.submitted} "
                     f"served={rep.served} shed={rep.shed} "
                     f"p50={tp['p50_ms']:.1f}ms p99={tp['p99_ms']:.1f}ms")
    shared = st["shared"]
    line = (f"shared: served={sum(tp['served'] for tp in per.values())} "
            f"tenants={shared['num_tenants']} "
            f"device_bytes={shared['device_bytes']}")
    if mgr.arbiter is not None and mgr.arbiter.last_shares:
        shares = " ".join(f"{n}={s:.2f}"
                          for n, s in mgr.arbiter.last_shares.items())
        line += (f" arbiter_rounds={len(mgr.arbiter.events)} "
                 f"shares[{shares}]")
    lines.append(line)
    return lines


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.tenants:
        for line in run_tenants(args):
            print(line, flush=True)
        return
    if args.trace:
        for line in run_trace(args):
            print(line, flush=True)
        return
    levels = HOTNESS if args.hotness == "all" else (args.hotness,)
    for hotness in levels:
        print(format_line(hotness, run_session(args, hotness)), flush=True)


if __name__ == "__main__":
    main()
