#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs a GPU

Phases, each printing one JSON line and its seconds; any failure raises
and the script exits non-zero:

  1. device       card name, power limit, TF32 off for matmul and cuDNN
  2. build        the CUDA embedding-bag and fused-lookup kernels, from the
                  sources here, one nvcc each, in parallel
  3. parity       kernel vs its plain version (ref.embedding_bag_ref) on the
                  card: sum/mean, weights on/off, num_hot 0/>0, f32/bf16,
                  ragged B at every bags-per-block value, vector and scalar
                  D, D=256 (two row passes), L=1, L under the ring depth,
                  L=257, ring depths 2-16, out-of-range indices, one table
                  at the serve shape (R=500K, B=2048, L=150, D=128) and the
                  completion shape (T=1, B=2048, L=150) through its caller
  4. parity_fused the fused kernel vs fused_warm_lookup_plain on the card:
                  sum/mean, weights on/off, hot K 0/>0, all-hit, mixed,
                  PAD and all-miss slot maps, ragged B at every
                  bags-per-block value, D=128, 256 and 33, L=1, 5, 24, 257,
                  T=3 in one launch, a bad slot and a bad row (NaN), bf16;
                  one table at the serve shape with a warm cache; and the
                  law on a small model: tiered pooled output equals the
                  device kernel's bit for bit (hot set, refresh, update)
  5. serve        dlrm_production at full width through ServingSession on
                  the `device` backend: 3 batches of 2048 med_hot queries;
                  the kernel launches once per forward; a 64-query
                  sub-batch's logits match the plain path
  6. kernel_time  kernel, plain version and torch's embedding_bag at the
                  serve shape (CUDA events), the memory bound, the
                  registers and resident blocks per SM of the instantiation
                  launched, and a breakdown of one batch's time
  6b. kernel_diag the bag kernel at the serve shape on four index sets
                  (served, all distinct, L2-resident, one row per table),
                  the completion shape, and the fused kernel's two passes
                  on a slot map made from the served batch
  6c. replay_device  phase serve's model under a flash crowd on a virtual
                  clock: service time measured at max_batch=256, an SLO of
                  3x its p99, the shrink rung down to 32; sheds, levels,
                  batch sizes, one bag launch per forward, a sample
                  batch's logits against the plain path
  7. serve_tiered the same weights and the first 2 of those batches on the
                  `tiered` backend (hot 50K + warm 50K rows per table on
                  the card, the cold tier on the host, async prefetch); the
                  fused kernel launches once per forward; logits match
                  phase serve's
  8. kernel_time_fused  at the serve shape with the warm state serving
                  left: the fused kernel held to its plain version on all
                  tables (pooled within the bound, miss lists exact); its
                  time (and its pool and list passes apart), the plain
                  version's and a torch embedding_bag's
                  over [hot; cache] (pooled half only); the bound; and a
                  breakdown of one tiered batch
  8b. replay_tiered  the tiered storage under a flash crowd: max_batch=128,
                  the shrink rung down to 16, then the degraded rung, and
                  back to level 0; degraded and exact batch times; no
                  completion launch in a degraded batch; every exact
                  answer equal to the device kernel's bit for bit; one
                  degraded batch against the plain degraded pooling and
                  its L2 delta against a recompute
  8c. update      online updates at full width, 8 tables: device, tiered
                  and sharded (2 shards) sessions on one update stream (a
                  full base, two deltas of 2 % of 3 tables' rows); after
                  the run each batch against the plain path over its
                  version's tables, tiered == sharded == device bit for
                  bit, every qid's version
  8d. serve_sharded  full width, 64 tables: the `device` reference, then
                  the `sharded` backend on 4 shards (serve_tiered's tiers,
                  contiguous placement): 2 batches of 2048, logits ==
                  device's bit for bit, one fused launch per unit a
                  forward; a live migration to a placement that replicates
                  table 0 on two shards, routing updates, the 2 batches
                  again; one batch with the shards in parallel and one
                  serially with each shard's breakdown
  8e. replay_tenants  two tenants (steady, flash) of 32 tables on one
                  shared sharded backend (2 shards), max_batch 128
                  unpadded, on a virtual clock: `fair` scheduling with the
                  budget arbiter, then `fifo` without; every answer equal
                  to the tenant's bag-kernel pooling, every arbiter round
                  within the budget, each tenant's p99 and shed share
  9. kernels      one line per ported kernel (the PERF.md rows), with
                  registers, blocks per SM and fraction of the bound, and
                  the launches of each phase that drives it

The last line is {"ok": true, "device": {...}}. There is no CPU branch.
`--stop-after PHASE` ends the run after that phase (build, parity_fused,
kernel_time, kernel_diag, replay_device, replay_tiered, serve_sharded,
replay_tenants; a short first call for a new kernel); the result lines
are then not printed.
`--geometry-sweep` makes kernel_diag also time both kernels at each of
seven launch geometries (bags per block x ring depth).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint import CheckpointManager, ModelUpdateStream  # noqa: E402
from repro_torch.configs.dlrm_production import CONFIG  # noqa: E402
from repro_torch.core.access_patterns import (PAPER_UNIQUE_PCT,  # noqa: E402
                                              make_pattern)
from repro_torch.core.embedding import _pool_rows_core, gather_rows  # noqa: E402
from repro_torch.kernels.embedding_bag import fused, kernel, ops, ref  # noqa: E402
from repro_torch.models import DLRM  # noqa: E402
from repro_torch.ps import PSConfig  # noqa: E402
from repro_torch.serving import (ArbiterConfig, BatcherConfig,  # noqa: E402
                                 ServingSession, SLOConfig, TenantManager,
                                 TenantSpec, UpdateConfig, configure)
from repro_torch.traffic import (TimedQuery, VirtualClock,  # noqa: E402
                                 make_traffic, replay, replay_tenants)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM data sheet, f32 outside tensor cores
SERVE_BATCHES = 3
# serve_tiered serves the first two of them (a tiered batch of 2048 takes
# about 50 s on the host; the script stays near half its time limit)
SERVE_TIERED_BATCHES = 2
SUB_BATCH = 64
# device bytes kept free beside the tables: a batch's indices, interaction
# and MLP activations, the sub-batch's plain gather, the timing phase's
# flattened indices
HEADROOM_BYTES = 8 * 10**9
# tier sizes of serve_tiered: the repo's convention of rows // 10 per tier
TIER_FRACTION = 10
# host bytes kept free beside what serve_tiered holds per table: a batch's
# slot map, one table's completion rows, the allocator's slack
HOST_HEADROOM_BYTES = 4 * 10**9
# host bytes of one entry of a warm tag store's row -> slot dict
LOC_ENTRY_BYTES = 128
# seed of the trace batch the hot set is planned from: not a served batch
TRACE_SEED = 100
# replay_device: the SLO ladder's shrink rung from 256 down to 32, and a
# flash trace whose spike (16 batch times) outlasts its 5,000 queries, so
# every SLO check after the spike starts falls inside it (a query's
# indices are 150 KB: 5,000 queries hold 750 MB of host memory)
REPLAY_DEVICE_BATCH, REPLAY_DEVICE_MIN = 256, 32
REPLAY_DEVICE_QUERIES = 5000
# replay_tiered: 128 down to 16, then the degraded rung; 2,000 queries
# (300 MB beside the 64 GB cold tier); a 64-query SLO window, so the
# windowed p99 forgets the spike within the base traffic that follows it
REPLAY_TIERED_BATCH, REPLAY_TIERED_MIN = 128, 16
REPLAY_TIERED_QUERIES = 2000
REPLAY_TIERED_WINDOW = 64
REPLAY_TIERED_SPIKE = 5             # batch times
# update: full width with 8 tables (a full base snapshot of all 250 is
# 64 GB on disk), batches of 512, versions published after steps 1, 3, 5
UPDATE_TABLES, UPDATE_BATCH, UPDATE_STEPS = 8, 512, 8
UPDATE_PUBLISH_AFTER = (1, 3, 5)
UPDATE_SHARDS = 2
# serve_sharded: 64 tables (each unit copies its tables beside the
# authoritative copy: host memory, and a tiered batch's host work a table)
# on 4 shards, 2 batches of 2048 before and after a live migration planned
# from a skewed window (table 0 `random`, the next 15 `one_item`). A load
# is the mean distinct rows a query (150 for `random`, 133.7 for med_hot,
# 1 for `one_item`), so the live imbalance of the contiguous split is 1.30
# and a replication factor of 0.085 (a limit of 140 rows) splits table 0
# alone over two shards
SHARDED_TABLES, SHARDED_SHARDS, SHARDED_BATCHES = 64, 4, 2
SKEWED_ONE_ITEM_TABLES = 15
SHARDED_MIGRATE_THRESHOLD = 1.1
SHARDED_REPLICATE = 0.085
# replay_tenants: two tenants of 32 tables on one backend of 2 shards,
# batches of 128 unpadded; steady ~400 queries at 0.5x one batch's service
# rate, flash ~1,200 at 0.25x with a spike 4x its base for 8 batch times
TENANT_TABLES, TENANT_SHARDS, TENANT_BATCH = 32, 2, 128
TENANT_STEADY_QUERIES, TENANT_FLASH_QUERIES = 400, 1200


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def expect(failed: list, cond: bool, msg: str) -> None:
    """A check whose failure is collected: the phase prints its line with
    the `failed` list, then main raises."""
    if not cond:
        failed.append(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sample_indices(pattern, batch: int, tables: int, pooling: int,
                   seed: int, workers: int = 8) -> np.ndarray:
    """[batch, tables, pooling] int32 drawn from `pattern`, in `workers`
    chunks on threads (numpy's searchsorted releases the GIL)."""
    rows = batch * tables
    bounds = np.linspace(0, rows, workers + 1).astype(int)
    with ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(
            lambda k: pattern.sample(int(bounds[k + 1] - bounds[k]), pooling,
                                     seed=seed * workers + k),
            range(workers)))
    return np.concatenate(parts).reshape(batch, tables, pooling)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fused_pass_ms(cache, slots, rows, hot, num_rows, opts,
                  iters: int) -> tuple[float, float]:
    """CUDA-event times of the fused lookup's two kernels apart: the
    gather-and-pool pass (`fused.pool_tables`) and the miss-list pass
    (`fused.list_tables`, on the pool pass's counts and bitmap)."""
    pool = lambda: fused.pool_tables(cache, slots, rows, None, hot,  # noqa: E731
                                     num_rows, opts)
    pool_ms = cuda_ms(pool, iters=iters)
    _, bag_miss, bitmap = pool()
    lists_ms = cuda_ms(lambda: fused.list_tables(slots, rows, bag_miss,
                                                 bitmap, num_rows),
                       iters=iters)
    return pool_ms, lists_ms


def check_geometry(opts, info: dict, dim: int, itemsize: int,
                   weighted: bool, name: str) -> None:
    """Hold the launch geometry's accounting (`kernel.LaunchGeometry`:
    ring depth, bags per block, dynamic shared bytes) to what the library
    reports it launched. The scalar path (row bytes not a multiple of 16)
    has no ring and reports depth 0."""
    vec = dim * itemsize % 16 == 0
    want = {"ring_depth": opts.ring_depth() if vec else 0,
            "bags_per_block": opts.batch_block,
            "dynamic_shared_bytes": opts.shared_bytes(dim, itemsize,
                                                      weighted)}
    got = {k: info[k] for k in want}
    check(got == want, f"{name}: launched {got}, the accounting says {want}")


def compare(got, want, bound, name: str) -> dict:
    """|got - want| <= bound elementwise; NaN only where `want` is NaN."""
    got, want, bound = got.float(), want.float(), bound.float()
    nan = torch.isnan(want)
    check(bool(torch.equal(torch.isnan(got), nan)),
          f"{name}: NaN pattern differs from the plain version")
    err = (got - want).abs().masked_fill(nan, 0)
    excess = (err - bound.masked_fill(nan, 0)).max().item()
    check(excess <= 0, f"{name}: max error {err.max().item():.3e} exceeds "
                       f"its bound by {excess:.3e}")
    return {"case": name, "max_abs_err": err.max().item(),
            "max_err_over_bound": (err / bound.clamp_min(1e-30)).max().item()}


def phase_parity() -> dict:
    """Hold the kernel to its plain version. f32: `ref.summation_bound`
    (2·eps·Σ|w·x|, carried through the mean's division). bf16: the kernel
    accumulates in f32 and rounds once on store, so it is held to the
    plain version on the f32 upcast of the same table, unrounded, with the
    f32 bound plus one bf16 rounding of the result (2^-8·|ref|)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    results = []

    def case(dtype, dim, pooling, mode, weighted, num_hot, batch=13,
             tables=3, rows=1000, pd=8, bb=8, bad_rows=False):
        tab = torch.randn((tables, rows, dim), generator=gen, device=dev)
        tab = tab.to(dtype)
        idx = torch.randint(0, rows, (batch, tables, pooling), generator=gen,
                            device=dev, dtype=torch.int32)
        if bad_rows:
            idx[0, 0, 0], idx[batch - 1, tables - 1, pooling - 1] = -1, rows
        w = (torch.rand((batch, tables, pooling), generator=gen, device=dev)
             if weighted else None)
        opts = kernel.EmbeddingBagOpts(prefetch_distance=pd, batch_block=bb,
                                       num_hot=num_hot, mode=mode)
        got = kernel.embedding_bag_cuda(tab, idx, w, opts)
        name = (f"{str(dtype)[6:]} D={dim} L={pooling} {mode} "
                f"w={int(weighted)} hot={num_hot} pd={pd} bb={bb} B={batch}"
                + (" bad_rows" if bad_rows else ""))
        check_geometry(opts, kernel.last_launch_info(), dim,
                       tab.element_size(), weighted, name)
        torch.cuda.synchronize()
        want, bound = [], []
        for t in range(tables):
            wt = None if w is None else w[:, t]
            safe = idx[:, t].clamp(0, rows - 1)
            want.append(ref.embedding_bag_ref(tab[t].float(), safe, wt, mode))
            bound.append(ref.summation_bound(tab[t].float(), safe, wt, mode))
        want, bound = torch.stack(want, 1), torch.stack(bound, 1)
        if bad_rows:   # an index outside [0, R) poisons its bag with NaN
            want[0, 0] = float("nan")
            want[batch - 1, tables - 1] = float("nan")
        if dtype == torch.bfloat16:   # one rounding of the f32 result
            bound = bound + 2.0 ** -8 * (want.abs() + bound)
        results.append(compare(got, want, bound, name))

    for dtype, dim, pooling in ((torch.float32, 128, 70),
                                (torch.float32, 33, 8),
                                (torch.bfloat16, 128, 150),
                                (torch.bfloat16, 36, 5)):
        for mode in ("sum", "mean"):
            for weighted in (False, True):
                for num_hot in (0, 100):
                    case(dtype, dim, pooling, mode, weighted, num_hot)
    for pd, bb in ((1, 1), (3, 3), (16, 8), (5, 2)):
        case(torch.float32, 128, 40, "mean", True, 50, batch=29, pd=pd, bb=bb)
    case(torch.float32, 128, 20, "sum", False, 0, bad_rows=True)
    case(torch.float32, 33, 20, "mean", True, 10, bad_rows=True)
    # the shared-memory ring's geometry: D=256 (two 512-byte passes), L=1,
    # L shorter than the ring, L=257 (past two 32-lookup windows), ragged
    # B at every bags-per-block value, ring depths 2-16
    for dim, pooling in ((256, 40), (128, 1), (128, 5), (128, 257),
                         (256, 257)):
        case(torch.float32, dim, pooling, "sum", False, 100)
        case(torch.float32, dim, pooling, "mean", True, 100)
    case(torch.float32, 256, 70, "sum", False, 0, bad_rows=True)
    for pd in (2, 4, 16):
        case(torch.float32, 128, 3, "sum", False, 0, pd=pd)
        case(torch.float32, 128, 100, "mean", True, 0, pd=pd)
    for bb in range(1, 9):
        case(torch.float32, 128, 40, "sum", False, 50, batch=29, bb=bb)
    case(torch.bfloat16, 256, 257, "mean", True, 100)

    # the single-table wrappers in ops go through the same kernel
    tab = torch.randn((1000, 128), generator=gen, device=dev)
    idx = torch.randint(0, 1000, (13, 9), generator=gen, device=dev)
    results.append(compare(
        ops.embedding_bag(tab, idx, mode="mean", backend="cuda"),
        ref.embedding_bag_ref(tab, idx, mode="mean"),
        ref.summation_bound(tab, idx, mode="mean"), "ops.embedding_bag"))
    tok = torch.randint(0, 1000, (4, 7), generator=gen, device=dev)
    check(bool(torch.equal(ops.embedding_lookup(tab, tok, backend="cuda"),
                           ref.embedding_lookup_ref(tab, tok))),
          "ops.embedding_lookup differs from the plain gather")

    # one table at the main path's shape, indices from the med_hot pattern
    rows, dim, batch, pooling = 500_000, 128, 2048, 150
    tab = torch.randn((1, rows, dim), generator=gen, device=dev) / dim ** 0.5
    idx_np = make_pattern("med_hot", rows, seed=0).sample(batch, pooling, 7)
    idx = torch.from_numpy(idx_np).to(dev)[:, None]
    got = kernel.embedding_bag_cuda(tab, idx, None, kernel.EmbeddingBagOpts())
    results.append(compare(
        got[:, 0], ref.embedding_bag_ref(tab[0], idx[:, 0]),
        ref.summation_bound(tab[0], idx[:, 0]),
        "serve shape R=500000 B=2048 L=150 D=128 f32 sum"))
    # the completion shape, through its caller: T=1, 2048 bags of 150 rows
    # read once, pooled by fused.pool_bag_rows
    n, pooling, dim = 2048, 150, 128
    bag_rows = torch.randn((n, pooling, dim), generator=gen, device=dev)
    flat = bag_rows.view(n * pooling, dim)
    ar = torch.arange(n * pooling, device=dev).view(n, pooling)
    for mode in ("sum", "mean"):
        results.append(compare(
            fused.pool_bag_rows(bag_rows, mode=mode),
            ref.embedding_bag_ref(flat, ar, mode=mode),
            ref.summation_bound(flat, ar, mode=mode),
            f"completion shape T=1 B={n} L={pooling} D={dim} f32 {mode}"))
    del bag_rows, flat, ar
    f32 = [r for r in results if not r["case"].startswith("bfloat16")]
    return {"cases": len(results),
            "max_abs_err_f32": max(r["max_abs_err"] for r in f32),
            "max_err_over_bound": max(r["max_err_over_bound"]
                                      for r in results),
            "results": results}


def _fused_plain(cache, slots, rows, w, hot, num_rows, mode):
    """The plain version per table (pooled [B, T, D]) and its miss lists."""
    pooled, mrows, mpos = [], [], []
    s_np, r_np = slots.cpu().numpy(), rows.cpu().numpy()
    for t in range(slots.shape[1]):
        pooled.append(fused.fused_warm_lookup_plain(
            cache[t], slots[:, t], rows[:, t],
            None if w is None else w[:, t],
            None if hot is None else hot[t], mode=mode, num_rows=num_rows))
        r, p = fused._miss_list_from_slots(s_np[:, t], r_np[:, t], num_rows)
        mrows.append(r)
        mpos.append(p)
    return torch.stack(pooled, 1), mrows, mpos


def _fused_bound(cache, slots, w, hot, mode):
    """`ref.summation_bound` of each table's bags over the rows they add:
    hot and warm hits; MISS, PAD and bad positions add a zero row."""
    bounds = []
    num_hot = 0 if hot is None else hot.shape[1]
    cache_rows, dim = cache.shape[1], cache.shape[2]
    for t in range(slots.shape[1]):
        parts = ([] if hot is None else [hot[t].float()]) + [
            cache[t].float(), torch.zeros((1, dim), device=cache.device)]
        eff = torch.cat(parts)
        s = slots[:, t].long()
        zero_row = num_hot + cache_rows
        idx = torch.where((s >= 0) & (s < zero_row), s,
                          torch.full_like(s, zero_row))
        bounds.append(ref.summation_bound(
            eff, idx, None if w is None else w[:, t], mode))
    return torch.stack(bounds, 1)


def _check_lists(got_rows, got_pos, want_rows, want_pos, name):
    for t, (gr, gp, wr, wp) in enumerate(zip(got_rows, got_pos, want_rows,
                                             want_pos)):
        check(np.array_equal(gr, wr), f"{name}: table {t} miss_rows differ "
                                      f"({gr.size} vs {wr.size})")
        check(np.array_equal(gp, wp), f"{name}: table {t} miss_pos differ "
                                      f"({gp.size} vs {wp.size})")


def _tiered_twin(model, combine: str, ps_cfg, trace):
    """A tiered model holding `model`'s tables on the host and sharing its
    MLPs, its tiers built from `trace`."""
    emb = dataclasses.replace(model.cfg.embedding, storage="tiered",
                              combine=combine)
    twin = DLRM(dataclasses.replace(model.cfg, embedding=emb),
                device="cuda", tables=model.ebc.tables.cpu())
    twin.bottom, twin.top = model.bottom, model.top
    twin.ebc.storage.build(ps_cfg, trace=trace)
    return twin


def phase_parity_fused() -> dict:
    """Hold the fused kernel to `fused_warm_lookup_plain` on the card.

    Pooled f32: `ref.summation_bound` over the rows each bag adds (zero at
    MISS/PAD), carried through the mean's division. bf16: against the
    plain version on the f32 upcast, plus one bf16 rounding of the stored
    raw sum and, for a mean, one of the epilogue's quotient. miss_rows,
    miss_pos: exactly equal. Then the law: the tiered backend's pooled
    output equals the device kernel's bit for bit (torch.equal), fused and
    per-row paths, sum and mean."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    results = []

    def case(dtype, dim, pooling, mode, weighted, num_hot, mix, batch=13,
             tables=3, rows=1000, cache_rows=200, bad=False, bb=8):
        cache = torch.randn((tables, cache_rows, dim), generator=gen,
                            device=dev).to(dtype)
        hot = (torch.randn((tables, num_hot, dim), generator=gen,
                           device=dev).to(dtype) if num_hot else None)
        ids = torch.randint(0, rows, (batch, tables, pooling), generator=gen,
                            device=dev, dtype=torch.int32)
        hits = torch.randint(0, num_hot + cache_rows, ids.shape,
                             generator=gen, device=dev, dtype=torch.int32)
        draw = torch.rand(ids.shape, generator=gen, device=dev)
        if mix == "hit":
            slots = hits
        elif mix == "miss":
            slots = torch.full_like(ids, fused.MISS)
        elif mix == "pad":   # hits and PAD positions, no miss
            slots = torch.where(draw < 0.5, torch.full_like(ids, fused.PAD),
                                hits)
        else:   # mixed: misses, PAD positions and two all-PAD bags
            slots = torch.where(draw < 0.4, torch.full_like(ids, fused.MISS),
                                hits)
            slots = torch.where(draw > 0.95, torch.full_like(ids, fused.PAD),
                                slots)
            slots[batch - 2:] = fused.PAD
        if bad:   # a slot past the cache, a MISS whose row is out of range
            slots[0, 0, 0] = num_hot + cache_rows
            slots[batch - 1, tables - 1, pooling - 1] = fused.MISS
            ids[batch - 1, tables - 1, pooling - 1] = rows
        slots, ids = slots.contiguous(), ids.contiguous()
        w = (torch.rand(ids.shape, generator=gen, device=dev)
             if weighted else None)
        opts = fused.FusedLookupOpts(batch_block=bb)
        raw, mrow, mpos, counts = fused.launch_tables(cache, slots, ids, w,
                                                      hot, rows, opts)
        name = (f"{str(dtype)[6:]} D={dim} L={pooling} {mode} "
                f"w={int(weighted)} hot={num_hot} {mix} B={batch} T={tables}"
                f" bb={bb}" + (" bad" if bad else ""))
        check_geometry(opts, fused.last_launch_info(), dim,
                       cache.element_size(), weighted, name)
        got = fused.mean_epilogue(raw, w, pooling, mode)
        got_rows, got_pos = fused.lists_to_host(mrow, mpos, counts)
        torch.cuda.synchronize()
        up = (lambda x: x) if dtype == torch.float32 else \
            (lambda x: None if x is None else x.float())
        want, want_rows, want_pos = _fused_plain(
            up(cache), slots, ids, w, up(hot), rows, mode)
        bound = _fused_bound(cache, slots, w, hot, mode)
        if dtype == torch.bfloat16:
            # the raw sum is stored in bf16 (one rounding); a mean's f32
            # epilogue rounds its quotient once more
            roundings = 2 if mode == "mean" else 1
            bound = bound + roundings * 2.0 ** -8 * (
                want.abs().nan_to_num() + bound)
        if bad:
            check(bool(torch.isnan(got[0, 0]).all()
                       and torch.isnan(got[batch - 1, tables - 1]).all()),
                  f"{name}: bad input did not give NaN")
        _check_lists(got_rows, got_pos, want_rows, want_pos, name)
        results.append(compare(got, want, bound, name))

    for dim in (128, 33):
        for mode in ("sum", "mean"):
            for weighted in (False, True):
                for num_hot in (0, 64):
                    for mix in ("hit", "mixed", "miss"):
                        case(torch.float32, dim, 24, mode, weighted,
                             num_hot, mix)
    case(torch.float32, 128, 70, "sum", False, 64, "mixed", bad=True)
    case(torch.float32, 33, 5, "mean", True, 0, "mixed", bad=True)
    case(torch.bfloat16, 128, 40, "mean", True, 64, "mixed")
    case(torch.bfloat16, 36, 9, "sum", False, 0, "mixed")
    # the shared-memory ring's geometry, as in phase parity
    for dim, pooling in ((256, 40), (128, 1), (128, 5), (128, 257)):
        for mix in ("mixed", "pad", "miss"):
            case(torch.float32, dim, pooling, "sum", False, 64, mix)
            case(torch.float32, dim, pooling, "mean", True, 0, mix)
    case(torch.float32, 256, 70, "sum", True, 64, "mixed", bad=True)
    for bb in range(1, 9):
        case(torch.float32, 128, 40, "sum", False, 64, "mixed", batch=29,
             bb=bb)

    # the single-table wrapper, cuda against plain
    cache = torch.randn((300, 64), generator=gen, device=dev)
    sl = torch.randint(-2, 300, (29, 11), generator=gen, device=dev)
    rw = torch.randint(0, 5000, (29, 11), generator=gen, device=dev)
    a = fused.fused_warm_lookup(cache, sl, rw, mode="mean", backend="cuda")
    b = fused.fused_warm_lookup(cache, sl, rw, mode="mean", backend="plain")
    _check_lists([a.miss_rows], [a.miss_pos], [b.miss_rows], [b.miss_pos],
                 "fused_warm_lookup")
    results.append(compare(a.pooled, b.pooled, _fused_bound(
        cache[None], sl[:, None].int(), None, None, "mean")[:, 0],
        "fused_warm_lookup cuda vs plain"))

    # one table at the serve shape: med_hot rows, hot set planned from one
    # batch, the warm cache filled by looking up another
    R, K, B, L, D = 500_000, 50_000, 2048, 150, 128
    pattern = make_pattern("med_hot", R, seed=0)
    table = (torch.randn((1, R, D), generator=gen, device=dev)
             / D ** 0.5).cpu()
    emb = dataclasses.replace(CONFIG.embedding, num_tables=1, rows=R,
                              pooling=L, shard_pad_tables=0,
                              storage="tiered")
    one = DLRM(dataclasses.replace(CONFIG, embedding=emb), device="cuda",
               tables=table)
    one.ebc.storage.build(
        PSConfig(hot_rows=K, warm_slots=K, warm_backing="device",
                 fused_lookup=True),
        trace=pattern.sample(B, L, 11)[:, None])
    ps = one.ebc.storage.ps
    ps.lookup_fused(pattern.sample(B, L, 12)[:, None])
    idx = pattern.sample(B, L, 13)[:, None]
    slots = torch.from_numpy(ps.build_slot_map(idx)).to(dev)
    ids = torch.from_numpy(idx).to(dev)
    hot = ps._hot_dev
    raw, mrow, mpos, counts = fused.launch_tables(
        ps._warm_payload, slots, ids, None, hot, R, fused.FusedLookupOpts())
    got_rows, got_pos = fused.lists_to_host(mrow, mpos, counts)
    want, want_rows, want_pos = _fused_plain(ps._warm_payload, slots, ids,
                                             None, hot, R, "sum")
    name = "serve shape R=500000 K=C=50000 B=2048 L=150 D=128 f32 sum"
    _check_lists(got_rows, got_pos, want_rows, want_pos, name)
    serve_cmp = compare(raw, want,
                        _fused_bound(ps._warm_payload, slots, None, hot,
                                     "sum"), name)
    serve_cmp.update(hit_frac=float((slots >= 0).float().mean()),
                     miss_rows=int(got_rows[0].size),
                     miss_positions=int(got_pos[0].size))
    results.append(serve_cmp)
    one.ebc.storage.close()
    del one, ps, table, hot, slots, ids, raw, mrow, mpos, want

    # the law, on a small model: tiered == device, bit for bit
    law = []
    small = dataclasses.replace(
        CONFIG, embedding=dataclasses.replace(
            CONFIG.embedding, num_tables=3, rows=1000, pooling=20,
            shard_pad_tables=0))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 1000, (37, 3, 20)).astype(np.int32)
               for _ in range(4)]
    upd_rows = np.unique(batches[3][:, 1].ravel())[:40]
    upd_vals = rng.normal(size=(upd_rows.size, 128)).astype(np.float32)
    for combine in ("sum", "mean"):
        for fused_on in (True, False):
            device_model = DLRM(dataclasses.replace(
                small, embedding=dataclasses.replace(small.embedding,
                                                     combine=combine)),
                device="cuda", seed=3)
            twin = _tiered_twin(device_model, combine, PSConfig(
                hot_rows=100, warm_slots=200, warm_backing="device",
                fused_lookup=fused_on), trace=batches[0])
            steps = []
            for step in ("hot set", "warm", "refresh", "update"):
                if step == "refresh":
                    check(twin.ebc.storage.refresh()["replanned"],
                          "refresh did not re-plan")
                if step == "update":
                    for st in (device_model.ebc.storage, twin.ebc.storage):
                        st.begin_update(1)
                        st.apply_update(1, upd_rows, upd_vals)
                        st.commit_update(1)
                idx = batches[3 if step == "update" else 1]
                with torch.no_grad():
                    a = device_model.ebc(torch.from_numpy(idx).cuda())
                    b = twin.ebc(idx)
                check(bool(torch.equal(a, b)),
                      f"tiered != device ({combine}, fused={fused_on}, "
                      f"{step}): max diff {(a - b).abs().max().item():.3e}")
                steps.append(step)
            law.append({"combine": combine, "fused": fused_on,
                        "steps": steps, "equal": True})
            twin.ebc.storage.close()
    f32 = [r for r in results if not r["case"].startswith("bfloat16")]
    return {"cases": len(results),
            "max_abs_err_f32": max(r["max_abs_err"] for r in f32),
            "max_err_over_bound": max(r["max_err_over_bound"]
                                      for r in results),
            "serve_shape": serve_cmp, "law": law, "results": results}


def host_available_bytes() -> int:
    """Host memory this process may still take: MemAvailable, or less
    where a cgroup limit is set (a container reports its host's memory in
    /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read())
        if limit != "max":
            avail = min(avail, int(limit) - used)
    except OSError:
        pass
    return avail


def host_rss_bytes() -> int | None:
    """This process's resident set now (/proc/self/statm), or None where
    the file is missing."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


def host_peak_rss_bytes() -> int:
    """This process's peak resident set (getrusage's ru_maxrss, in KiB on
    Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def tiered_host_bytes_per_table(ps_cfg, batch: int, pooling: int, rows: int,
                                dim: int) -> int:
    """Host bytes a table of the tiered backend holds while serving: the
    cold tier, the plans' two int64 [R] permutations, the warm tag store
    (three int64 [C] arrays and the row -> slot dict), and the staged
    payloads of prefetch_depth future batches plus the one being consumed:
    their distinct cold rows, at most med_hot's share of unique rows per
    batch (20.5 % of B·L)."""
    staged_rows = int(PAPER_UNIQUE_PCT["med_hot"] / 100 * batch * pooling)
    return (rows * dim * 4 + 2 * rows * 8
            + ps_cfg.warm_slots * (3 * 8 + LOC_ENTRY_BYTES)
            + (ps_cfg.prefetch_depth + 1) * staged_rows * dim * 4)


def phase_serve_tiered(model, batches, serve_logits, deadline_s: float):
    """The same weights and batches as phase serve, on the tiered backend.
    Takes `model` apart: its tables go to the host, its MLPs are reused,
    and its device tables are freed before the tiers are built. Returns
    (fields, the session, the tiered model) — the session stays open so
    phase kernel_time_fused finds the warm state serving left."""
    emb = dataclasses.replace(model.cfg.embedding, storage="tiered")
    T, R, L, D = emb.num_tables, emb.rows, emb.pooling, emb.dim
    B = batches[0][1].shape[0]
    ps_cfg = tier_ps_config(R)
    per_table = tiered_host_bytes_per_table(ps_cfg, B, L, R, D)
    avail = host_available_bytes()
    rss = {"start": host_rss_bytes()}
    fit = (avail - HOST_HEADROOM_BYTES) // per_table
    cut = None
    if fit < T:
        cut = {"num_tables": [T, int(fit)],
               "reason": f"{avail} bytes of host memory available, "
                         f"{per_table} needed per table"}
        T = int(fit)
        emb = dataclasses.replace(emb, num_tables=T)
        batches = [(d, i[:, :T].copy()) for d, i in batches]
    t1 = time.perf_counter()
    host_tables = model.ebc.tables[:T].cpu()
    model.ebc.tables = None            # free the device copy (64 GB)
    gc.collect()
    torch.cuda.empty_cache()
    to_host_s = time.perf_counter() - t1
    rss["tables_on_host"] = host_rss_bytes()
    tiered = DLRM(dataclasses.replace(model.cfg, embedding=emb),
                  device="cuda", tables=host_tables, seed=0)
    # the top MLP's input width follows T: after a cut the model keeps its
    # own, and its logits are not phase serve's
    tiered.bottom = model.bottom
    if cut is None:
        tiered.top = model.top
    del host_tables
    pattern = make_pattern("med_hot", R, seed=0)
    trace = sample_indices(pattern, B, T, L, seed=TRACE_SEED)
    t1 = time.perf_counter()
    tiered.ebc.storage.build(ps_cfg, trace=trace)
    build_s = time.perf_counter() - t1
    del trace
    rss["tiers_built"] = host_rss_bytes()
    torch.cuda.reset_peak_memory_stats()
    scores = []
    fused.LAUNCHES = 0
    kernel.LAUNCHES = 0
    t1 = time.perf_counter()
    sess = ServingSession(tiered, batcher=BatcherConfig(max_batch=B,
                                                        max_wait_s=0.0))
    warmup_s = time.perf_counter() - t1
    sess.server.on_batch = lambda batch, s: scores.append(s.copy())
    for dense, idx in batches:
        sess.submit_batch(dense, idx)
    rss["warmed_up"] = host_rss_bytes()
    sess.drain(timeout_s=deadline_s)
    rss["served"] = host_rss_bytes()
    fused_launches, bag_launches = fused.LAUNCHES, kernel.LAUNCHES
    lat = np.asarray(sess.stats.batch_latencies_s) * 1e3
    forwards = 1 + len(lat)                       # warmup + served batches
    check(len(lat) == len(batches) and sess.stats.served == B * len(lat),
          f"served {sess.stats.served} queries in {len(lat)} batches")
    check(fused_launches == forwards,
          f"fused kernel launched {fused_launches} times over {forwards} "
          f"forwards")
    logits = np.concatenate(scores)
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    max_diff = sub_batch = None
    if cut is None:
        max_diff = float(np.abs(logits - serve_logits).max())
        check(bool(np.allclose(logits, serve_logits, rtol=1e-4, atol=1e-4)),
              f"tiered logits differ from phase serve's by {max_diff:.3e}")
    else:
        # a sub-batch's pooled output against the plain pooling of the same
        # rows of the host tables
        idx64 = batches[0][1][:SUB_BATCH]
        rows = torch.from_numpy(tiered.ebc.storage.ps.cold.tables[
            np.arange(T)[None, :, None], idx64])          # [64, T, L, D]
        with torch.no_grad():
            got = tiered.ebc(idx64).cpu()
        sub_batch = compare(got, _pool_rows_core(rows, None, emb.combine),
                            2 * ref.F32_EPS * rows.abs().sum(dim=2),
                            "tiered sub-batch pooled (after a cut)")
        del rows
    st = sess.stats.storage_stats
    keys = ("total_accesses", "hot_hits", "warm_hits", "cold_misses",
            "hot_hit_rate", "warm_hit_rate", "cold_miss_rate",
            "cache_hit_rate", "cold_gathered_rows", "evictions",
            "insertions", "warm_occupancy", "staged_rows", "prefetch_hits",
            "prefetch_misses", "queue_depth", "max_queue_depth",
            "off_critical_frac", "consume_ready", "consume_waited",
            "consume_wait_s", "consume_overlap_frac")
    fields = dict(
        config="dlrm_production", backend="tiered", tables=T, rows=R,
        dim=D, pooling=L, batch=B, cut=cut, ps_config=dataclasses.asdict(
            ps_cfg), batches=len(lat), batch_ms=lat.tolist(),
        p50_batch_ms=float(np.percentile(lat, 50)),
        p99_batch_ms=float(np.percentile(lat, 99)),
        fused_launches=fused_launches, bag_kernel_launches=bag_launches,
        forwards=forwards, logits_max_abs_diff_vs_serve=max_diff,
        logits_tolerance="rtol=1e-4 atol=1e-4", sub_batch_after_cut=sub_batch,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        device_tier_bytes=ps_cfg.device_bytes(T, D),
        host_available_bytes=avail, host_bytes_estimate=per_table * T,
        host_bytes_per_table_estimate=per_table,
        host_peak_rss_bytes=host_peak_rss_bytes(), host_rss_bytes=rss,
        host_peak_growth_bytes=(host_peak_rss_bytes() - rss["start"]
                                if rss["start"] is not None else None),
        tables_to_host_s=to_host_s,
        build_s=build_s, warmup_s=warmup_s,
        stats={k: st[k] for k in keys if k in st})
    return fields, sess, tiered, batches


def phase_kernel_time_fused(sess, tiered, batches) -> dict:
    """Fused kernel at the serve shape with the warm state serving left:
    the kernel held to its plain version on every table (pooled within
    the summation bound, miss lists exactly equal); CUDA-event times of
    the kernel, its plain version and a torch embedding_bag over
    [hot; cache] (pooled half only); the bound; and a breakdown of one
    tiered batch."""
    ps = sess.storage.ps
    dense_np, idx_np = batches[0]
    B, T, L = idx_np.shape
    D, R = ps.cold.dim, ps.cold.num_rows
    K, C = ps.num_hot, ps.cfg.warm_slots
    dev = torch.device("cuda")
    slots = torch.from_numpy(ps.build_slot_map(idx_np)).to(dev)
    ids = torch.from_numpy(idx_np).to(dev)
    hot = ps._hot_dev
    cache = ps._warm_payload
    opts = fused.FusedLookupOpts()
    run = lambda: fused.launch_tables(cache, slots, ids, None, hot, R,  # noqa: E731
                                      opts)
    ms = cuda_ms(run, iters=10, warmup=2)
    pool_ms, lists_ms_dev = fused_pass_ms(cache, slots, ids, hot, R, opts,
                                          iters=5)
    raw, mrow, mpos, counts = run()
    info = fused.last_launch_info()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    miss_rows, miss_pos = fused.lists_to_host(mrow, mpos, counts)
    lists_ms = (time.perf_counter() - t1) * 1e3
    n_distinct = sum(int(r.size) for r in miss_rows)
    n_occ = sum(int(p.size) for p in miss_pos)

    def plain():
        out = []
        for t in range(T):
            out.append(fused.fused_warm_lookup_plain(
                cache[t], slots[:, t], ids[:, t], None, hot[t], num_rows=R))
            s, r = slots[:, t].reshape(-1), ids[:, t].reshape(-1)
            miss = torch.nonzero(s == fused.MISS).flatten()
            torch.unique(r[miss])
        return torch.stack(out, 1)
    plain_ms = cuda_ms(plain, iters=1)
    name = (f"serve shape, served warm state: B={B} T={T} L={L} D={D} "
            f"K=C={K} f32 sum")
    held = compare(raw, plain(), _fused_bound(cache, slots, None, hot, "sum"),
                   name)
    slots_np = slots.cpu().numpy()
    want = [fused._miss_list_from_slots(slots_np[:, t], idx_np[:, t], R)
            for t in range(T)]
    _check_lists(miss_rows, miss_pos, [w[0] for w in want],
                 [w[1] for w in want], name)
    del slots_np, want

    # the library yardstick: F.embedding_bag over [hot; cache] per table,
    # the slot map as indices and 0/1 weights — the pooled half only
    both = torch.cat([hot, cache], dim=1).view(-1, D)       # [T(K+C), D]
    flat = (slots.long().clamp_min(0)
            + torch.arange(T, device=dev)[None, :, None] * (K + C)).reshape(-1)
    psw = (slots >= 0).float().reshape(-1)
    offsets = torch.arange(0, flat.numel(), L, device=dev)
    library = lambda: F.embedding_bag(flat, both, offsets, mode="sum",  # noqa: E731
                                      per_sample_weights=psw)
    library_ms = cuda_ms(library, iters=3)
    library_err = (library().view(B, T, D) - raw).abs().max().item()
    del both, flat, psw, offsets

    # bytes the function must move: each distinct hit row once, the slot
    # map, the row ids at MISS positions, the output, the bitmap pass and
    # the miss lists; operations: a multiply-add per hit element
    hit_rows = 0
    for t in range(T):
        s = slots[:, t]
        hit_rows += int(torch.unique(s[s >= 0]).numel())
    words = -(-R // 32)
    moved = (hit_rows * D * 4 + slots.numel() * 4 + n_occ * 4
             + raw.numel() * 4 + T * words * 4 + (n_distinct + n_occ) * 4
             + counts.numel() * 4)
    hits = int((slots >= 0).sum())
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = hits * D * 2 / F32_OPS_PER_S * 1e3

    # one tiered batch, step by step (device synchronised at each step)
    ps.breakdown = {}
    t1 = time.perf_counter()
    with torch.no_grad():
        pooled = tiered.ebc(idx_np)
    torch.cuda.synchronize()
    lookup_s = time.perf_counter() - t1
    breakdown = {k: v * 1e3 for k, v in ps.breakdown.items()}
    ps.breakdown = None
    with torch.inference_mode():
        dense = torch.from_numpy(dense_np).cuda()
        breakdown["mlps_and_interaction"] = cuda_ms(
            lambda: tiered.forward_from_pooled(dense, pooled), iters=5)
    breakdown["lookup_total_host_clock"] = lookup_s * 1e3
    return dict(
        shape=[B, T, L, D], hot_rows=K, warm_slots=C, ms=ms,
        pool_pass_ms=pool_ms, list_pass_ms=lists_ms_dev, plain_ms=plain_ms,
        plain_max_abs_err=held["max_abs_err"],
        plain_max_err_over_bound=held["max_err_over_bound"],
        miss_lists_equal=True,
        library_ms=library_ms,
        library="torch.nn.functional.embedding_bag over [hot; cache] with "
                "0/1 per_sample_weights: the pooled half only",
        library_max_abs_diff=library_err, miss_list_copy_ms=lists_ms,
        hit_positions=hits, distinct_hit_rows=hit_rows,
        miss_positions=n_occ, distinct_miss_rows=n_distinct,
        bytes_moved=moved, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
        fraction_of_bound=max(bytes_ms, ops_ms) / ms, **info,
        launches_per_forward=1, breakdown_ms=breakdown)


def _bag_bound_ms(distinct_rows: int, lookups: int, outputs: int,
                  dim: int) -> float:
    """Bytes bound of an f32 bag launch: each distinct row once, the int32
    indices, the output."""
    moved = distinct_rows * dim * 4 + lookups * 4 + outputs * dim * 4
    return moved / HBM_BYTES_PER_S * 1e3


def phase_kernel_diag(tables, idx_served, pattern, opts,
                      geometry_sweep: bool) -> dict:
    """Where the bag kernel's time goes, at the serve shape [B, T, L] ->
    [B, T, D] f32 (CUDA events), on three index sets made from the seed:
    (a) the served med_hot batch 0; (b) distinct: each table's B·L lookups
    all different rows, a seeded permutation prefix of R, so every row
    comes from device memory; (c) resident: every lookup from 2,048 rows
    per table (1 MB a table), which L2 holds; (d) one row per table, which
    L1 holds: the loop's own cost. Beside each time, the
    registers per thread and the resident blocks per SM of the
    instantiation launched. Then the completion shape (T=1, B=2048 bags of
    L=150 rows read once, as `fused.pool_bag_rows` launches it), and the
    fused kernel at the serve shape on a slot map made from batch 0 (ranks
    below K+C hit, the rest MISS; hot and cache are views of the tables),
    with its pool and list passes timed apart. With `geometry_sweep`, both
    kernels again at each of seven launch geometries."""
    B, T, L = idx_served.shape
    R, D = tables.shape[1], tables.shape[2]
    dev = tables.device
    gen = torch.Generator(device=dev).manual_seed(13)
    resident_rows = 2048
    idx_distinct = torch.empty_like(idx_served)
    idx_resident = torch.empty_like(idx_served)
    idx_one = torch.empty_like(idx_served)
    resident_distinct = 0
    for t in range(T):
        perm = torch.randperm(R, generator=gen, device=dev)[:B * L].int()
        idx_distinct[:, t] = perm.view(B, L)
        pick = torch.randint(0, resident_rows, (B, L), generator=gen,
                             device=dev)
        idx_resident[:, t] = perm[pick]
        idx_one[:, t] = perm[0]
        resident_distinct += int(torch.unique(idx_resident[:, t]).numel())
    served_distinct = sum(int(torch.unique(idx_served[:, t]).numel())
                          for t in range(T))
    all_lookups_ms = B * T * L * D * 4 / HBM_BYTES_PER_S * 1e3
    sets = {}
    for name, idx, distinct in (
            ("a_served", idx_served, served_distinct),
            ("b_distinct", idx_distinct, B * T * L),
            ("c_resident", idx_resident, resident_distinct),
            ("d_one_row", idx_one, T)):
        ms = cuda_ms(lambda: kernel.embedding_bag_cuda(tables, idx, None,
                                                       opts),
                     iters=5, warmup=1)
        bound = _bag_bound_ms(distinct, B * T * L, B * T, D)
        sets[name] = dict(ms=ms, distinct_rows=distinct, bound_ms=bound,
                          fraction_of_bound=bound / ms,
                          lookup_bytes_per_s=B * T * L * D * 4 / ms * 1e3,
                          **kernel.last_launch_info())
    del idx_distinct, idx_resident, idx_one

    # the completion shape: [1, B·L, D] rows read once, indices arange
    n = 2048
    rows = torch.randn((1, n * L, D), generator=gen, device=dev)
    ar = torch.arange(n * L, dtype=torch.int32, device=dev).view(n, 1, L)
    copts = fused.COMPLETION_OPTS
    ms = cuda_ms(lambda: kernel.embedding_bag_cuda(rows, ar, None, copts),
                 iters=20, warmup=2)
    bound = _bag_bound_ms(n * L, n * L, n, D)
    completion = dict(shape=[n, 1, L, D], ms=ms, bound_ms=bound,
                      fraction_of_bound=bound / ms,
                      **kernel.last_launch_info())

    # the fused kernel at the serve shape on a slot map from batch 0
    K = C = R // TIER_FRACTION
    rank = np.empty(R, np.int64)
    rank[pattern.rank_to_row()] = np.arange(R)
    rank_dev = torch.from_numpy(rank).to(dev)
    slots = rank_dev[idx_served.long()]
    slots = torch.where(slots < K + C, slots,
                        torch.full_like(slots, fused.MISS)).int()
    del rank_dev
    hot, cache = tables[:, :K], tables[:, K:K + C]

    fopts = fused.FusedLookupOpts()
    ms = cuda_ms(lambda: fused.launch_tables(cache, slots, idx_served, None,
                                             hot, R, fopts),
                 iters=5, warmup=1)
    pool_ms, lists_ms = fused_pass_ms(cache, slots, idx_served, hot, R,
                                      fopts, iters=5)
    hit_rows = 0
    for t in range(T):
        s = slots[:, t]
        hit_rows += int(torch.unique(s[s >= 0]).numel())
    fused_diag = dict(ms=ms, pool_pass_ms=pool_ms, list_pass_ms=lists_ms,
                      hit_frac=float((slots >= 0).float().mean()),
                      distinct_hit_rows=hit_rows, **fused.last_launch_info())

    # with geometry_sweep, both kernels at each launch geometry: the bag
    # kernel on (a), the fused kernel's pool pass on its slot map, the
    # completion shape
    geometries = (((8, 2), (8, 4), (8, 8), (8, 16), (4, 4), (4, 8), (2, 8))
                  if geometry_sweep else ())
    sweep = []
    for bb, pd in geometries:
        geo = dict(batch_block=bb, prefetch_distance=pd)
        o = dataclasses.replace(opts, **geo)
        bag_ms = cuda_ms(lambda: kernel.embedding_bag_cuda(
            tables, idx_served, None, o), iters=3, warmup=1)
        info = kernel.last_launch_info()
        co = dataclasses.replace(copts, **geo)
        comp_ms = cuda_ms(lambda: kernel.embedding_bag_cuda(
            rows, ar, None, co), iters=20, warmup=2)
        fused_pool_ms = cuda_ms(lambda: fused.pool_tables(
            cache, slots, idx_served, None, hot, R,
            fused.FusedLookupOpts(**geo)), iters=3)
        sweep.append(dict(geo, ring_depth=info["ring_depth"],
                          registers=info["registers"],
                          blocks_per_sm=info["blocks_per_sm"],
                          bag_served_ms=bag_ms, completion_ms=comp_ms,
                          fused_pool_pass_ms=fused_pool_ms,
                          fused_registers=fused.last_launch_info()[
                              "registers"]))
    del slots, hot, cache, rows, ar
    return dict(shape=[B, T, L, D], resident_rows_per_table=resident_rows,
                all_lookups_ms_at_peak=all_lookups_ms, sets=sets,
                sweep=sweep, completion=completion,
                fused_synthetic=fused_diag)


# -- replay, SLO ladder and online updates -----------------------------------

class LookupTap:
    """Wraps a storage backend's `lookup` to record, per forward, the rows
    looked up (the batch, padded or not), the queries in it (from the
    server's `hint_valid`), whether the backend was degraded, and the bag-
    and fused-kernel launches the lookup made; keeps the last lookup's
    indices and pooled output for a check after the batch (outside its
    timed service)."""

    def __init__(self, storage):
        self.storage = storage
        self.records = []
        self.last = None
        self._lookup = storage.lookup
        self._hint_valid = storage.hint_valid
        self._queries = None
        storage.lookup = self
        storage.hint_valid = self.hint_valid

    def hint_valid(self, n: int) -> None:
        self._queries = n
        self._hint_valid(n)

    def __call__(self, indices, weights=None, **kw):
        degraded = self.storage.degraded()
        bag0, fused0 = kernel.LAUNCHES, fused.LAUNCHES
        out = self._lookup(indices, weights, **kw)
        self.records.append({"rows": int(indices.shape[0]),
                             "queries": self._queries,
                             "degraded": degraded,
                             "bag": kernel.LAUNCHES - bag0,
                             "fused": fused.LAUNCHES - fused0})
        self.last = (indices, out)
        return out

    def remove(self) -> None:
        del self.storage.lookup, self.storage.hint_valid


def flash_trace(n: int, t_b: float, batch: int, emb, dense_features: int,
                pattern, seed: int, spike_len_batches: float):
    """`n` queries on a `flash` profile: base 0.5x the measured service
    rate (batch / t_b), a spike of 4x base from one batch time in, lasting
    `spike_len_batches` batch times. Arrivals are the flash generator's;
    indices come from the phase's med_hot `pattern` (one rank -> row map
    for every table, as served batches are made), since the tiered tiers
    were planned from it."""
    base = 0.5 * batch / t_b
    gen = make_traffic("flash", base_qps=base, spike_qps=4.0 * base,
                       spike_start_s=t_b, spike_len_s=spike_len_batches * t_b,
                       num_tables=emb.num_tables, rows=emb.rows,
                       pooling=emb.pooling, dense_features=dense_features,
                       seed=seed)
    return (timed_queries(gen, n, emb, dense_features, pattern, seed),
            gen.profile)


def timed_queries(gen, n: int, emb, dense_features: int, pattern,
                  seed: int) -> list:
    """`n` queries with `gen`'s arrival times and indices from `pattern`."""
    arrivals = gen.arrival_times(n)
    idx = sample_indices(pattern, n, emb.num_tables, emb.pooling, seed=seed)
    dense = np.random.default_rng(seed).normal(
        size=(n, dense_features)).astype(np.float32)
    return [TimedQuery(qid=i, arrival_s=float(arrivals[i]),
                       dense=dense[i], indices=idx[i]) for i in range(n)]


def calibrate_service(model, batch: int, dense, idx) -> np.ndarray:
    """Real service seconds of len(dense) // batch full batches through a
    session without controllers. Only its server is closed: the storage
    serves the replay next."""
    sess = ServingSession(model, batcher=BatcherConfig(max_batch=batch,
                                                       max_wait_s=0.0))
    sess.submit_batch(dense, idx)
    sess.drain(timeout_s=600.0)
    sess.server.close()
    return np.asarray(sess.stats.batch_latencies_s)


def replay_summary(sess, rep, tap, profile, target_ms: float) -> dict:
    """What a replay did: sheds by reason, SLO levels and actions, the
    batch sizes served, the SLO checks that fell inside the spike, and
    batch service times split by degraded and not."""
    tl = rep.timeline
    every = sess.slo.cfg.check_every_batches
    spike_end = profile.spike_start_s + profile.spike_len_s
    checks_in_spike = sum(1 for i, s in enumerate(tl)
                          if (i + 1) % every == 0
                          and profile.spike_start_s <= s.t_s < spike_end)
    lat = np.asarray(sess.stats.batch_latencies_s) * 1e3
    check(len(lat) == len(tap.records) == len(tl),
          f"{len(lat)} batches, {len(tap.records)} lookups, "
          f"{len(tl)} snapshots")
    deg = np.array([r["degraded"] for r in tap.records], bool)
    queries = np.array([r["queries"] for r in tap.records])
    check(int(queries.sum()) == rep.served, "lookups missed queries")

    def split(mask):
        if not mask.any():
            return None
        return {"batches": int(mask.sum()),
                "queries": int(queries[mask].sum()),
                "mean_batch_ms": float(lat[mask].mean()),
                "p50_batch_ms": float(np.percentile(lat[mask], 50)),
                "ms_per_query": float(lat[mask].sum()
                                      / queries[mask].sum())}
    sizes = collections.Counter(r["rows"] for r in tap.records)
    timeline = [[round(s.t_s, 4), s.served, s.shed, s.queue_len,
                 None if s.windowed_p99_ms is None
                 else round(s.windowed_p99_ms, 2), s.slo_level,
                 int(s.degraded), int(q), round(float(ms), 2)]
                for s, q, ms in zip(tl, queries, lat)]
    return dict(
        submitted=rep.submitted, admitted=rep.admitted, served=rep.served,
        shed=rep.shed, shed_frac=rep.shed_frac,
        shed_reasons=dict(sess.stats.shed_reasons),
        slo_target_p99_ms=target_ms,
        final_windowed_p99_ms=rep.final_windowed_p99_ms(),
        max_slo_level=max(s.slo_level for s in tl),
        final_slo_level=tl[-1].slo_level,
        slo_actions=[(e["action"], e["batch"]) for e in sess.slo.events],
        slo_checks_in_spike=checks_in_spike,
        spike_s=[profile.spike_start_s, spike_end],
        trace_end_s=tl[-1].t_s,
        batch_sizes_served=dict(sorted(sizes.items())),
        batches=len(lat), non_degraded=split(~deg), degraded=split(deg),
        bag_launches=sum(r["bag"] for r in tap.records),
        fused_launches=sum(r["fused"] for r in tap.records),
        bag_launches_in_degraded=sum(r["bag"] for r, d in
                                     zip(tap.records, deg) if d),
        percentiles={k: v for k, v in rep.percentiles.items()
                     if k.startswith(("p50", "p99", "slo_", "degraded_",
                                      "served", "shed"))},
        timeline_columns=["t_s", "served", "shed", "queue", "wp99_ms",
                          "level", "degraded", "queries", "service_ms"],
        timeline=timeline)


def phase_replay_device(model, pattern, src) -> dict:
    """dlrm_production on `device` under a flash crowd: service time
    measured at max_batch=256, an SLO of 3x its p99 with the shrink rung
    down to 32, a flash trace (base 0.5x the service rate, spike 4x base)
    that ends inside its spike, so at least 4 SLO checks fall in it. A
    sample batch's answers are held to the plain path on the card."""
    emb, F = model.cfg.embedding, model.cfg.dense_features
    dense, idx = src
    lat = calibrate_service(model, REPLAY_DEVICE_BATCH,
                            dense[:8 * REPLAY_DEVICE_BATCH],
                            idx[:8 * REPLAY_DEVICE_BATCH])
    p99_s, t_b = float(np.percentile(lat, 99)), float(lat.mean())
    t1 = time.perf_counter()
    queries, profile = flash_trace(REPLAY_DEVICE_QUERIES, t_b,
                                   REPLAY_DEVICE_BATCH, emb, F, pattern,
                                   seed=21, spike_len_batches=16)
    trace_s = time.perf_counter() - t1
    rss_trace = host_rss_bytes()
    target_ms = 3 * p99_s * 1e3
    sess = ServingSession(
        model, batcher=BatcherConfig(max_batch=REPLAY_DEVICE_BATCH,
                                     max_wait_s=0.002),
        slo=SLOConfig(target_p99_ms=target_ms,
                      min_batch=REPLAY_DEVICE_MIN, check_every_batches=2),
        clock=VirtualClock())
    tap = LookupTap(sess.storage)
    served = []
    sess.server.on_batch = lambda batch, s: served.append(
        ([q.qid for q in batch], s.copy()))
    kernel.LAUNCHES = 0
    t1 = time.perf_counter()
    rep = replay(sess, queries)
    replay_s = time.perf_counter() - t1
    launches = kernel.LAUNCHES
    tap.remove()
    sess.close()
    out = replay_summary(sess, rep, tap, profile, target_ms)
    failed = []
    expect(failed, launches == out["batches"] > 0,
           f"bag kernel launched {launches} times over {out['batches']} "
           f"forwards")
    expect(failed, out["slo_checks_in_spike"] >= 4,
           f"{out['slo_checks_in_spike']} SLO checks inside the spike")
    expect(failed, out["max_slo_level"] == 2,
           f"device replay reached SLO level {out['max_slo_level']}, not "
           f"the shrink rung (2)")
    expect(failed, set(out["batch_sizes_served"]) == {256, 128, 64, 32},
           f"batch sizes {out['batch_sizes_served']}")
    # a sample batch (the last full one at the shrink floor) against the
    # plain path
    full = [b for b in served if len(b[0]) == REPLAY_DEVICE_MIN]
    qids, scores = (full or served)[-1]
    d64 = torch.from_numpy(np.stack([queries[q].dense for q in qids])).cuda()
    i64 = torch.from_numpy(np.stack([queries[q].indices
                                     for q in qids])).cuda()
    with torch.inference_mode():
        rows = gather_rows(model.ebc.tables, i64)
        plain = model.forward_from_pooled(
            d64, _pool_rows_core(rows, None, emb.combine))
        del rows
    plain = plain.cpu().numpy()
    diff = float(np.abs(plain - scores).max())
    expect(failed, bool(np.isfinite(scores).all()), "non-finite logits")
    expect(failed, bool(np.allclose(scores, plain, rtol=1e-4, atol=1e-4)),
           f"replayed logits differ from the plain path by {diff:.3e}")
    return dict(
        config="dlrm_production", backend="device", tables=emb.num_tables,
        max_batch=REPLAY_DEVICE_BATCH, min_batch=REPLAY_DEVICE_MIN,
        calibration_batch_ms=(lat * 1e3).tolist(),
        service_p99_ms=p99_s * 1e3, service_rate_qps=REPLAY_DEVICE_BATCH / t_b,
        trace={"kind": "flash", "queries": len(queries),
               "base_qps": profile.base_qps, "spike_qps": profile.spike_qps,
               "seconds_to_make": trace_s},
        **out, sample_batch={"queries": len(qids),
                             "logits_max_abs_diff_vs_plain": diff,
                             "tolerance": "rtol=1e-4 atol=1e-4"},
        replay_s=replay_s, host_rss_bytes_after_trace=rss_trace,
        host_peak_rss_bytes=host_peak_rss_bytes(), failed=failed)


def compact_bag_pooled(host_tables, idx: np.ndarray, opts) -> torch.Tensor:
    """The `device` backend's answer for `idx` [B, T, L] without the
    device tables: each table's distinct rows copied to the card as a
    compact table, indices remapped into it, and the bag kernel launched
    over all tables, as phase serve launched it. A bag's rows and their
    order are the same, so the pooled sums are the same bits."""
    B, T, L = idx.shape
    uniq = [np.unique(idx[:, t]) for t in range(T)]
    U = max(u.size for u in uniq)
    D = host_tables.shape[2]
    compact = torch.zeros((T, U, D), dtype=torch.float32)
    remapped = np.empty_like(idx)
    for t, u in enumerate(uniq):
        compact[t, :u.size] = torch.from_numpy(host_tables[t]).index_select(
            0, torch.from_numpy(u.astype(np.int64)))
        remapped[:, t] = np.searchsorted(u, idx[:, t])
    launches = kernel.LAUNCHES
    out = kernel.embedding_bag_cuda(
        compact.cuda(), torch.from_numpy(remapped).cuda(), None, opts)
    kernel.LAUNCHES = launches          # a check, not the main path
    return out


def phase_replay_tiered(tiered, pattern, device_opts, src) -> dict:
    """The tiered storage serve_tiered built, under a flash crowd: service
    time measured at max_batch=128, an SLO of 3x its p99 with the shrink
    rung down to 16 and the degraded rung above it. Batches are not padded
    (a padded row costs a host gather on `tiered`). Every answer that is
    not degraded is held to the `device` kernel's bit for bit (the law);
    one degraded batch is held to the plain degraded pooling (misses as
    zeros), and its L2 delta to a recompute from the cold rows."""
    emb, F = tiered.cfg.embedding, tiered.cfg.dense_features
    storage = tiered.ebc.storage
    cold = storage.ps.cold.tables
    dense, idx = src
    n_cal = 3 * REPLAY_TIERED_BATCH
    lat = calibrate_service(tiered, REPLAY_TIERED_BATCH, dense[:n_cal],
                            idx[:n_cal])
    p99_s, t_b = float(np.percentile(lat, 99)), float(lat.mean())
    queries, profile = flash_trace(REPLAY_TIERED_QUERIES, t_b,
                                   REPLAY_TIERED_BATCH, emb, F, pattern,
                                   seed=22,
                                   spike_len_batches=REPLAY_TIERED_SPIKE)
    rss = {"trace": host_rss_bytes()}
    target_ms = 3 * p99_s * 1e3
    sess = ServingSession(
        tiered, batcher=BatcherConfig(max_batch=REPLAY_TIERED_BATCH,
                                      max_wait_s=0.002, pad_to_max=False),
        slo=SLOConfig(target_p99_ms=target_ms, min_batch=REPLAY_TIERED_MIN,
                      check_every_batches=2,
                      window_queries=REPLAY_TIERED_WINDOW),
        clock=VirtualClock())
    tap = LookupTap(storage)
    law = {"batches": 0, "queries": 0, "seconds": 0.0}
    failed = []

    def hold_to_device(batch, scores):
        indices, pooled = tap.last
        if tap.records[-1]["degraded"]:
            return
        t1 = time.perf_counter()
        want = compact_bag_pooled(cold, indices, device_opts)
        expect(failed, bool(torch.equal(pooled, want)),
               f"tiered != device on a replayed batch of {len(batch)}: "
               f"max diff {(pooled - want).abs().max().item():.3e}")
        law["batches"] += 1
        law["queries"] += len(batch)
        law["seconds"] += time.perf_counter() - t1
    sess.server.on_batch = hold_to_device
    kernel.LAUNCHES = fused.LAUNCHES = 0
    t1 = time.perf_counter()
    rep = replay(sess, queries, window_queries=REPLAY_TIERED_WINDOW)
    replay_s = time.perf_counter() - t1
    bag_launches, fused_launches = kernel.LAUNCHES, fused.LAUNCHES
    rss["replayed"] = host_rss_bytes()
    tap.remove()
    out = replay_summary(sess, rep, tap, profile, target_ms)
    expect(failed, fused_launches == out["batches"] > 0,
           f"fused kernel launched {fused_launches} times over "
           f"{out['batches']} forwards")
    expect(failed, bag_launches == out["bag_launches"] > 0,
           f"{bag_launches} completion launches, {out['bag_launches']} in "
           f"the lookups")
    expect(failed, out["max_slo_level"] == 3, f"tiered replay reached SLO "
           f"level {out['max_slo_level']}, not the degraded rung (3)")
    expect(failed, out["final_slo_level"] == 0,
           f"tiered replay ended at SLO level {out['final_slo_level']}")
    expect(failed, out["degraded"] is not None
           and out["non_degraded"] is not None,
           "no degraded or no exact batches")
    expect(failed, out["bag_launches_in_degraded"] == 0,
           f"{out['bag_launches_in_degraded']} completion launches in "
           f"degraded batches")
    expect(failed, out["non_degraded"] is not None
           and law["batches"] == out["non_degraded"]["batches"],
           f"law checked on {law['batches']} exact batches")

    # one degraded batch by hand: 16 fresh queries, the slot map read
    # before (no counter moves), then the lookup under degraded mode
    idx16 = sample_indices(pattern, 16, emb.num_tables, emb.pooling,
                           seed=23)
    storage.set_degraded(True)
    slot_map = storage.ps.build_slot_map(idx16)
    before = storage.stats()
    bag0 = kernel.LAUNCHES
    with torch.no_grad():
        got = tiered.ebc(idx16)
    torch.cuda.synchronize()
    bag_in_check = kernel.LAUNCHES - bag0
    after = storage.stats()
    storage.set_degraded(False)
    sess.close()
    miss = slot_map == fused.MISS                              # [16, T, L]
    rows = cold[np.arange(emb.num_tables)[None, :, None], idx16]
    rows[miss] = 0.0
    rows_t = torch.from_numpy(rows).cuda()
    plain = _pool_rows_core(rows_t, None, emb.combine)
    degraded_cmp = compare(got, plain,
                           2 * ref.F32_EPS * rows_t.abs().sum(dim=2),
                           "degraded batch pooled (misses as zeros)")
    del rows, rows_t
    miss_rows = cold[np.nonzero(miss)[1], idx16[miss]].astype(np.float64)
    l2_want = float(np.sqrt((miss_rows ** 2).sum()))
    l2_got = float(np.sqrt(after["degraded_l2_sq"]
                           - before["degraded_l2_sq"]))
    expect(failed, bag_in_check == 0, f"{bag_in_check} completion launches "
           f"in the degraded check batch")
    expect(failed, after["degraded_rows"] - before["degraded_rows"]
           == int(miss.sum()),
           "degraded_rows does not count the batch's misses")
    expect(failed, abs(l2_got - l2_want) <= 1e-6 * l2_want,
           f"degraded_l2_delta {l2_got} vs recompute {l2_want}")
    return dict(
        config="dlrm_production", backend="tiered", tables=emb.num_tables,
        max_batch=REPLAY_TIERED_BATCH, min_batch=REPLAY_TIERED_MIN,
        window_queries=REPLAY_TIERED_WINDOW, pad_to_max=False,
        calibration_batch_ms=(lat * 1e3).tolist(),
        service_p99_ms=p99_s * 1e3, service_rate_qps=REPLAY_TIERED_BATCH / t_b,
        trace={"kind": "flash", "queries": len(queries),
               "base_qps": profile.base_qps, "spike_qps": profile.spike_qps},
        **out, law={**law, "equal": True},
        degraded_check={"queries": 16, "misses": int(miss.sum()),
                        "max_abs_err": degraded_cmp["max_abs_err"],
                        "max_err_over_bound":
                            degraded_cmp["max_err_over_bound"],
                        "l2_delta": l2_got, "l2_delta_recomputed": l2_want,
                        "completion_launches": bag_in_check},
        replay_s=replay_s, host_rss_bytes=rss,
        host_peak_rss_bytes=host_peak_rss_bytes(), failed=failed)


def phase_update(cfg, pattern) -> dict:
    """Online updates at full width with the table count cut: `device`,
    `tiered` and `sharded` (2 shards) sessions over the same weights and
    one update stream (one full base, then two deltas touching 2 % of the
    rows of 3 tables), batches served between versions. After the run,
    every batch is held to the plain path over `load_version` tables of
    its pinned version, tiered and sharded to device bit for bit, and
    every qid's version to the schedule."""
    emb = dataclasses.replace(cfg.embedding, num_tables=UPDATE_TABLES)
    T, R, L, D = emb.num_tables, emb.rows, emb.pooling, emb.dim
    B = UPDATE_BATCH
    dev_model = DLRM(dataclasses.replace(cfg, embedding=emb),
                     device="cuda", seed=3)
    v0 = dev_model.ebc.tables[:T].to("cpu", copy=True)
    tiered = DLRM(dataclasses.replace(cfg, embedding=dataclasses.replace(
        emb, storage="tiered")), device="cuda", tables=v0.clone(), seed=3)
    tiered.bottom, tiered.top = dev_model.bottom, dev_model.top
    sharded = DLRM(dataclasses.replace(cfg, embedding=dataclasses.replace(
        emb, storage="sharded")), device="cuda", tables=v0.clone(), seed=3)
    sharded.bottom, sharded.top = dev_model.bottom, dev_model.top
    trace = sample_indices(pattern, B, T, L, seed=TRACE_SEED)
    tiered.ebc.storage.build(tier_ps_config(R), trace=trace)
    sharded.ebc.storage.build(tier_ps_config(R), trace=trace,
                              num_shards=UPDATE_SHARDS)
    sharded_units = len(sharded.ebc.storage._units)
    root = os.path.join(ROOT, "build", "chip_smoke_updates")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    disk = shutil.disk_usage(root)
    # consumers attach before the base is published, so the base lands
    # through the update path too
    sessions = {}
    for name, model in (("device", dev_model), ("tiered", tiered),
                        ("sharded", sharded)):
        sessions[name] = ServingSession(
            model, batcher=BatcherConfig(max_batch=B, max_wait_s=0.0),
            controllers=configure(updates=UpdateConfig(
                ModelUpdateStream(root), poll_every_batches=1)))
    pub = ModelUpdateStream(root)
    taps = {name: LookupTap(sess.storage) for name, sess in sessions.items()}
    served = {name: [] for name in sessions}
    traffic = {}                        # qid -> (dense, indices)
    for name, sess in sessions.items():
        sess.server.on_batch = lambda batch, s, out=served[name]: out.append(
            ([q.qid for q in batch], s.copy()))
    rng = np.random.default_rng(4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    std = float(dev_model.ebc.tables[:T].std())
    published = []
    failed = []
    kernel.LAUNCHES = fused.LAUNCHES = 0
    t_serve = time.perf_counter()
    for step in range(UPDATE_STEPS):
        dense = rng.normal(size=(B, cfg.dense_features)).astype(np.float32)
        idx = sample_indices(pattern, B, T, L, seed=40 + step)
        traffic.update((step * B + i, (dense[i], idx[i])) for i in range(B))
        for sess in sessions.values():
            sess.submit_batch(dense, idx, qid0=step * B)
            while sess.poll(force=True):
                pass
        if step in UPDATE_PUBLISH_AFTER:
            t1 = time.perf_counter()
            if not published:
                v = pub.publish_full(torch.randn(
                    (T, R, D), generator=gen, device="cuda") * std)
            else:
                changed = {}
                for t in rng.choice(T, size=3, replace=False):
                    rows = rng.choice(R, size=R // 50, replace=False)
                    changed[int(t)] = (rows, (rng.normal(
                        size=(rows.size, D)) * std).astype(np.float32))
                v = pub.publish_delta(changed)
            published.append({"version": v, "after_step": step,
                              "publish_s": time.perf_counter() - t1})
    for sess in sessions.values():
        sess.drain(timeout_s=600.0)
    serve_s = time.perf_counter() - t_serve
    launches = {name: {"forwards": len(tap.records),
                       "bag": sum(r["bag"] for r in tap.records),
                       "fused": sum(r["fused"] for r in tap.records)}
                for name, tap in taps.items()}
    for tap in taps.values():
        tap.remove()
    dev_n, tier_n = launches["device"], launches["tiered"]
    shard_n = launches["sharded"]
    expect(failed, kernel.LAUNCHES == dev_n["bag"] + tier_n["bag"]
           + shard_n["bag"] and fused.LAUNCHES == tier_n["fused"]
           + shard_n["fused"],
           f"launches outside the lookups: {kernel.LAUNCHES} bag, "
           f"{fused.LAUNCHES} fused")
    expect(failed, dev_n["bag"] == dev_n["forwards"] == UPDATE_STEPS
           and tier_n["fused"] == tier_n["forwards"] == UPDATE_STEPS
           and tier_n["bag"] > 0 and shard_n["forwards"] == UPDATE_STEPS
           and shard_n["fused"] == sharded_units * UPDATE_STEPS
           and shard_n["bag"] > 0, f"launches in the update run: {launches}")
    pct = {name: sess.percentiles() for name, sess in sessions.items()}
    disk_used = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, files in os.walk(root) for f in files)
    for name, p in pct.items():
        got = (p["model_version"], p["updates_applied"], p["updates_full"],
               p["updates_delta"])
        expect(failed, got == (3, 3, 1, 2),
               f"{name}: (version, applied, full, delta) = {got}")

    # every batch single-version, the same version in every session, and
    # tiered == sharded == device bit for bit
    dev_batches = served["device"]
    by_version = collections.defaultdict(list)
    for other in ("tiered", "sharded"):
        expect(failed, [b[0] for b in dev_batches]
               == [b[0] for b in served[other]],
               f"device and {other} served other batches")
        for (qids, d_scores), (_, o_scores) in zip(dev_batches,
                                                   served[other]):
            vs = {sessions["device"].version_of(q) for q in qids}
            vo = {sessions[other].version_of(q) for q in qids}
            expect(failed, len(vs) == 1 and vs == vo,
                   f"batch versions: device {vs}, {other} {vo}")
            expect(failed, bool(np.array_equal(d_scores, o_scores)),
                   f"{other} != device after an update: max diff "
                   f"{np.abs(d_scores - o_scores).max():.3e}")
    for qids, d_scores in dev_batches:
        v = sessions["device"].version_of(qids[0])
        by_version[v].append((qids, d_scores))
    # the schedule: a version published after step s is applied after the
    # first batch of step s + 1, so step s + 2 is the first served by it
    for step in range(UPDATE_STEPS):
        want = sum(1 for p in published if p["after_step"] + 2 <= step)
        for q in (step * B, (step + 1) * B - 1):
            got = sessions["device"].version_of(q)
            expect(failed, got == want,
                   f"qid {q} (step {step}) pinned to v{got}, not v{want}")
    expect(failed, sorted(by_version) == [0, 1, 2, 3],
           f"versions served: {sorted(by_version)}")

    # each version's batches against the plain path over its tables
    mgr = CheckpointManager(root)
    plain_diff = {}
    for v, batches_v in sorted(by_version.items()):
        tables_v = v0.numpy() if v == 0 else mgr.load_version(v)
        worst = 0.0
        for qids, scores in batches_v:
            d = torch.from_numpy(np.stack([traffic[q][0]
                                           for q in qids])).cuda()
            i = np.stack([traffic[q][1] for q in qids])
            rows = torch.from_numpy(
                tables_v[np.arange(T)[None, :, None], i]).cuda()
            with torch.inference_mode():
                logits = dev_model.forward_from_pooled(
                    d, _pool_rows_core(rows, None, emb.combine)).cpu().numpy()
            del rows
            diff = float(np.abs(logits - scores).max())
            worst = max(worst, diff)
            expect(failed, bool(np.allclose(scores, logits, rtol=1e-4,
                                            atol=1e-4)),
                   f"v{v}: logits differ from the plain path over its "
                   f"tables by {diff:.3e}")
        plain_diff[f"v{v}"] = {"batches": len(batches_v),
                               "logits_max_abs_diff": worst}
        del tables_v
    for sess in sessions.values():
        sess.close()
    shutil.rmtree(root, ignore_errors=True)
    keep = ("model_version", "updates_applied", "updates_full",
            "updates_delta", "updates_rolled_back", "update_stall_s",
            "p50_ms", "p99_ms", "mean_batch_ms", "served")
    return dict(
        config="dlrm_production", tables=T, rows=R, dim=D, pooling=L,
        batch=B, steps=UPDATE_STEPS,
        cut={"num_tables": [cfg.embedding.num_tables, T],
             "reason": "a full base snapshot of 250 tables is 64 GB on "
                       "disk and in host memory"},
        published=published, launches=launches,
        sessions={name: {k: p[k] for k in keep if k in p}
                  for name, p in pct.items()},
        plain=plain_diff, tiered_equals_device=True,
        sharded_equals_device=True, sharded_shards=UPDATE_SHARDS,
        sharded_units=sharded_units,
        logits_tolerance="rtol=1e-4 atol=1e-4",
        disk={"free_bytes": disk.free, "total_bytes": disk.total,
              "stream_bytes": disk_used},
        serve_s=serve_s, host_peak_rss_bytes=host_peak_rss_bytes(),
        failed=failed)


def tier_ps_config(rows: int) -> PSConfig:
    """serve_tiered's tiers: rows // 10 hot and warm rows a table on the
    card, the fused kernel, async staging two batches deep."""
    return PSConfig(hot_rows=rows // TIER_FRACTION,
                    warm_slots=rows // TIER_FRACTION, warm_backing="device",
                    fused_lookup=True, async_prefetch=True, prefetch_depth=2)


def skewed_indices(batch: int, tables: int, pooling: int, rows: int,
                   seed: int) -> np.ndarray:
    """[batch, tables, pooling] with the `sharded_migration` bench's
    patterns on the first tables — table 0 `random`, tables 1-15
    `one_item` — and med_hot on the rest: a live window whose loads leave
    the contiguous placement lopsided and table 0 heavy enough to be
    replicated."""
    idx = sample_indices(make_pattern("med_hot", rows, seed=0), batch,
                         tables, pooling, seed=seed)
    for t in range(min(tables, 1 + SKEWED_ONE_ITEM_TABLES)):
        kind = "random" if t == 0 else "one_item"
        idx[:, t] = make_pattern(kind, rows, seed=t).sample(
            batch, pooling, seed=seed * 1000 + t)
    return idx


def shard_breakdown(storage) -> dict:
    """Each shard's `ParameterServer.breakdown` (its units summed), ms."""
    out = {}
    for u in storage._units:
        for step, s in (u.ps.breakdown or {}).items():
            key = f"shard{u.shard}"
            out.setdefault(key, {})
            out[key][step] = out[key].get(step, 0.0) + s * 1e3
    return out


def phase_serve_sharded(cfg, pattern) -> dict:
    """dlrm_production at full width with the table count cut, on the
    `sharded` backend: the `device` reference first (the bag kernel), then
    4 shards of serve_tiered's tiers on a contiguous placement, the same 2
    batches through a session (logits equal `device`'s bit for bit, one
    fused launch per unit a forward), a live migration to a placement
    that replicates table 0 on two shards (`plan_migration` on a skewed
    window, `install_migration`, routing observations folded by
    `update_routing`), and the 2 batches again. Then one batch timed with
    the shards in parallel and one serially, the latter with each shard's
    `ParameterServer.breakdown`."""
    gc.collect()                # earlier phases' collections and storages
    emb = dataclasses.replace(cfg.embedding, num_tables=SHARDED_TABLES)
    R, L, D = emb.rows, emb.pooling, emb.dim
    B = 2048
    ps_cfg = tier_ps_config(R)
    # the tiered backend's host bytes a table, plus the authoritative copy
    # the units are copied from, plus the second unit copy a migration
    # builds before it tears the first down
    per_table = tiered_host_bytes_per_table(ps_cfg, B, L, R, D) \
        + 2 * R * D * 4
    avail = host_available_bytes()
    rss = {"start": host_rss_bytes()}
    T = min(SHARDED_TABLES, int((avail - HOST_HEADROOM_BYTES) // per_table))
    reduced = [{"num_tables": [cfg.embedding.num_tables, SHARDED_TABLES],
                "reason": "each unit copies its tables beside the "
                          "authoritative copy: host memory (about 880 MB "
                          "a table with a migration in flight) and the "
                          "host work of a tiered batch per table"}]
    if T < SHARDED_TABLES:
        reduced.append({"num_tables": [SHARDED_TABLES, T],
                        "reason": f"{avail} bytes of host memory "
                                  f"available, {per_table} needed a table"})
    emb = dataclasses.replace(emb, num_tables=T)
    cfg_t = dataclasses.replace(cfg, embedding=emb)
    rng = np.random.default_rng(6)
    batches = [(rng.normal(size=(B, cfg.dense_features)).astype(np.float32),
                sample_indices(pattern, B, T, L, seed=60 + s))
               for s in range(SHARDED_BATCHES)]
    failed = []
    torch.cuda.reset_peak_memory_stats()

    def serve(model, name):
        scores = []
        sess = ServingSession(model, batcher=BatcherConfig(max_batch=B,
                                                           max_wait_s=0.0))
        sess.server.on_batch = lambda batch, s: scores.append(s.copy())
        for dense, idx in batches:
            sess.submit_batch(dense, idx)
        sess.drain(timeout_s=600.0)
        lat = np.asarray(sess.stats.batch_latencies_s) * 1e3
        expect(failed, len(lat) == len(batches),
               f"{name}: {len(lat)} batches served")
        return sess, np.concatenate(scores), lat

    # the `device` reference: the same tables on the card, the bag kernel
    dev = DLRM(cfg_t, device="cuda", seed=5)
    kernel.LAUNCHES = 0
    sess, dev_logits, dev_lat = serve(dev, "device")
    sess.close()
    dev_launches = kernel.LAUNCHES
    expect(failed, dev_launches == 1 + len(batches),
           f"device: {dev_launches} bag launches in {1 + len(batches)} "
           f"forwards")
    expect(failed, bool(np.isfinite(dev_logits).all()),
           "device: non-finite logits")
    t1 = time.perf_counter()
    host_tables = dev.ebc.tables.cpu()
    dev.ebc.tables = None
    gc.collect()
    torch.cuda.empty_cache()
    to_host_s = time.perf_counter() - t1
    sharded = DLRM(dataclasses.replace(cfg_t, embedding=dataclasses.replace(
        emb, storage="sharded")), device="cuda", tables=host_tables, seed=5)
    sharded.bottom, sharded.top = dev.bottom, dev.top
    del dev, host_tables
    st = sharded.ebc.storage
    trace = sample_indices(pattern, B, T, L, seed=TRACE_SEED)
    t1 = time.perf_counter()
    st.build(ps_cfg, trace=trace, num_shards=SHARDED_SHARDS,
             placement="contiguous", replicate_factor=SHARDED_REPLICATE)
    build_s = time.perf_counter() - t1
    del trace
    rss["built"] = host_rss_bytes()
    units_before = len(st._units)
    expect(failed, units_before == SHARDED_SHARDS,
           f"{units_before} units on {SHARDED_SHARDS} shards")

    tap = LookupTap(st)
    kernel.LAUNCHES = fused.LAUNCHES = 0
    sess, logits, lat = serve(sharded, "sharded")
    rss["served"] = host_rss_bytes()
    before = {"batch_ms": lat.tolist(),
              "fused_launches": fused.LAUNCHES,
              "bag_launches": kernel.LAUNCHES,
              "fused_per_forward": [r["fused"] for r in tap.records],
              "units": units_before}
    expect(failed, all(r["fused"] == units_before for r in tap.records)
           and len(tap.records) == 1 + len(batches),
           f"fused launches per forward {before['fused_per_forward']}, "
           f"{units_before} units")
    equal = bool(np.array_equal(logits, dev_logits))
    expect(failed, equal, f"sharded != device: max diff "
           f"{np.abs(logits - dev_logits).max():.3e}")
    stats = st.stats()
    expect(failed, stats["hot_hits"] + stats["warm_hits"]
           + stats["cold_misses"] == stats["total_accesses"] > 0,
           "merged stats break hot + warm + cold == total")
    keys = ("total_accesses", "hot_hits", "warm_hits", "cold_misses",
            "cache_hit_rate", "cold_gathered_rows", "prefetch_hits",
            "prefetch_misses", "off_critical_frac", "max_queue_depth")
    before.update(logits_equal_device=equal,
                  stats={k: stats[k] for k in keys if k in stats})

    # live migration, planned from a skewed window (med_hot's equal loads
    # give no plan), installed between batches while the session serves
    window = skewed_indices(B, T, L, R, seed=70)
    t1 = time.perf_counter()
    plan = st.plan_migration({"traffic": [window]},
                             threshold=SHARDED_MIGRATE_THRESHOLD)
    plan_s = time.perf_counter() - t1
    del window
    check(plan is not None, "serve_sharded: the skewed window gave no "
                            "migration plan")
    mig = plan["migration"]
    t1 = time.perf_counter()
    res = st.install_migration(plan)
    install_s = time.perf_counter() - t1
    rss["migrated"] = host_rss_bytes()
    replicated = {int(t): list(mig.new.replicas[t])
                  for t in mig.new.replicated_tables}
    expect(failed, res["migrated"] and 0 in replicated
           and len(replicated[0]) == 2,
           f"migration {res}, replicated {replicated}")
    units_after = len(st._units)
    tap.records.clear()
    kernel.LAUNCHES = fused.LAUNCHES = 0
    scores = []
    sess.server.on_batch = lambda batch, s: scores.append(s.copy())
    routing = []
    for dense, idx in batches:
        sess.submit_batch(dense, idx)
        sess.drain(timeout_s=600.0)
        routing.append(st.update_routing())
    lat2 = np.asarray(sess.stats.batch_latencies_s[-len(batches):]) * 1e3
    logits2 = np.concatenate(scores)
    equal2 = bool(np.array_equal(logits2, dev_logits))
    expect(failed, equal2, f"sharded after migration != device: max diff "
           f"{np.abs(logits2 - dev_logits).max():.3e}")
    expect(failed, len(tap.records) == len(batches)
           and all(r["fused"] == units_after for r in tap.records),
           f"after migration: fused launches per forward "
           f"{[r['fused'] for r in tap.records]}, {units_after} units")
    expect(failed, routing[0] is not None and 0 in routing[0]["fractions"],
           f"routing: {routing}")
    stats = st.stats()
    expect(failed, stats["hot_hits"] + stats["warm_hits"]
           + stats["cold_misses"] == stats["total_accesses"],
           "merged stats break hot + warm + cold == total after migration")
    after = {"batch_ms": lat2.tolist(), "fused_launches": fused.LAUNCHES,
             "bag_launches": kernel.LAUNCHES,
             "fused_per_forward": [r["fused"] for r in tap.records],
             "units": units_after, "logits_equal_device": equal2,
             "routing": routing}
    tap.remove()
    sess.server.close()

    # one batch with the shards in parallel, one serially with each
    # shard's breakdown (the device synchronised at each step)
    idx = batches[0][1]
    timing = {}
    for mode in ("parallel", "serial"):
        pool = st._pool
        if mode == "serial":
            st._pool = None
            for u in st._units:
                u.ps.breakdown = {}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            pooled = sharded.ebc(idx)
        torch.cuda.synchronize()
        timing[f"{mode}_ms"] = (time.perf_counter() - t1) * 1e3
        st._pool = pool
    timing["breakdown_ms"] = shard_breakdown(st)
    for u in st._units:
        u.ps.breakdown = None
    want = compact_bag_pooled(st._tables, idx, emb.kernel_opts())
    expect(failed, bool(torch.equal(pooled, want)),
           "serial fan-out != the bag kernel's pooling")
    del pooled, want
    peak = torch.cuda.max_memory_allocated()
    rss["timed"] = host_rss_bytes()
    sess.close()
    # the collection and its storage point at each other: gc frees them
    del sess, sharded, st, tap
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        config="dlrm_production", backend="sharded", tables=T, rows=R,
        dim=D, pooling=L, batch=B, shards=SHARDED_SHARDS,
        placement="contiguous", reduced=reduced,
        ps_config=dataclasses.asdict(ps_cfg),
        device={"batch_ms": dev_lat.tolist(), "bag_launches": dev_launches},
        before_migration=before,
        migration={"window": "table 0 random, tables 1-15 one_item (the "
                             "sharded_migration bench's patterns), the rest "
                             "med_hot: med_hot's equal loads give no plan",
                   "threshold": SHARDED_MIGRATE_THRESHOLD,
                   "replicate_factor": SHARDED_REPLICATE,
                   "describe": mig.describe(), "replicated": replicated,
                   "moved_tables": len(mig.moved_tables),
                   "imbalance_before": res.get("imbalance_before"),
                   "imbalance_after": res.get("imbalance_after"),
                   "plan_s": plan_s, "install_s": install_s},
        after_migration=after, timing=timing,
        peak_memory_bytes=peak, host_rss_bytes=rss,
        host_available_bytes=avail, host_bytes_estimate=per_table * T,
        tables_to_host_s=to_host_s, build_s=build_s, failed=failed)


def phase_replay_tenants(cfg, pattern) -> dict:
    """Two tenants, `steady` and `flash`, 32 tables each at full width,
    over ONE shared sharded backend (2 shards, tiers of rows // 10), on a
    virtual clock with max_batch 128 and unpadded batches, twice: `fair`
    scheduling with the budget arbiter, `fifo` without. Traffic is set in
    multiples of one tenant batch's service time measured here. Every
    answer is held to the tenant's own bag-kernel pooling bit for bit;
    every arbiter round to the shared budget; every tenant forward to one
    fused launch per unit of that tenant."""
    gc.collect()
    R, L, D = cfg.embedding.rows, cfg.embedding.pooling, cfg.embedding.dim
    B = TENANT_BATCH
    ps_cfg = tier_ps_config(R)
    names = ("steady", "flash")
    # per table: the tiered host bytes, the tenant model's host tables and
    # the union stack the units are copied from
    per_table = tiered_host_bytes_per_table(ps_cfg, 2048, L, R, D) \
        + 2 * R * D * 4
    avail = host_available_bytes()
    T = min(TENANT_TABLES, int((avail - HOST_HEADROOM_BYTES) // per_table
                               // len(names)))
    reduced = [{"num_tables": [cfg.embedding.num_tables, TENANT_TABLES],
                "per": "tenant",
                "reason": "host memory (the tenant tables, the union stack "
                          "and the units' copies) and the host work of a "
                          "tiered batch per table"}]
    if T < TENANT_TABLES:
        reduced.append({"num_tables": [TENANT_TABLES, T], "per": "tenant",
                        "reason": f"{avail} bytes of host memory "
                                  f"available, {per_table} needed a table"})
    emb = dataclasses.replace(cfg.embedding, num_tables=T,
                              storage="sharded")
    models = {n: DLRM(dataclasses.replace(cfg, embedding=emb),
                      device="cuda", seed=7 + i)
              for i, n in enumerate(names)}
    own_storage = {n: m.ebc.storage for n, m in models.items()}
    rss = {"models": host_rss_bytes()}
    trace = sample_indices(pattern, 2048, len(names) * T, L,
                           seed=TRACE_SEED)
    failed = []

    def manager(scheduling, arbiter):
        return TenantManager(
            [TenantSpec(n, m) for n, m in models.items()],
            backend="sharded",
            batcher=BatcherConfig(max_batch=B, max_wait_s=0.002,
                                  pad_to_max=False),
            controllers=configure(arbiter=arbiter), scheduling=scheduling,
            clock=VirtualClock(), ps_cfg=ps_cfg, trace=trace,
            num_shards=TENANT_SHARDS)

    built = ps_cfg.device_bytes(len(names) * T, D)

    def streams(t_b: float):
        svc_qps = B / t_b
        spec = {
            "steady": dict(kind="steady", n=TENANT_STEADY_QUERIES,
                           base_qps=0.5 * svc_qps),
            "flash": dict(kind="flash", n=TENANT_FLASH_QUERIES,
                          base_qps=0.25 * svc_qps, spike_qps=svc_qps,
                          spike_start_s=t_b, spike_len_s=8.0 * t_b)}
        out = {}
        for i, (name, s) in enumerate(spec.items()):
            gen = make_traffic(
                s["kind"], base_qps=s["base_qps"],
                spike_qps=s.get("spike_qps"),
                spike_start_s=s.get("spike_start_s", 1.0),
                spike_len_s=s.get("spike_len_s", 1.0),
                num_tables=T, rows=R, pooling=L,
                dense_features=cfg.dense_features, seed=90 + i)
            out[name] = timed_queries(gen, s["n"], emb, cfg.dense_features,
                                      pattern, seed=90 + i)
        return spec, out

    calib = {}

    def run_leg(leg: str, scheduling: str) -> dict:
        """One leg on a manager of its own; everything that views the
        leg's union stack is local here, so it is freed on return."""
        arbiter = (ArbiterConfig(every_batches=8, budget_fallback_bytes=built)
                   if scheduling == "fair" else None)
        t1 = time.perf_counter()
        mgr = manager(scheduling, arbiter)
        leg_build_s = time.perf_counter() - t1
        if arbiter is not None:
            # the budget the arbiter splits: the bytes the tiers were built
            # with (a round reads the card's free memory x the fraction)
            free, _ = torch.cuda.mem_get_info()
            arbiter = dataclasses.replace(arbiter,
                                          budget_fraction=built / free)
            mgr.arbiter.cfg = arbiter
        rss[f"{leg}_built"] = host_rss_bytes()
        shared = mgr.shared
        if not calib:
            # one tenant batch's service time, on the first leg's backend;
            # the probe batches are not traffic
            view = mgr.views["steady"]
            probe = sample_indices(pattern, 3 * B, T, L, seed=80)
            dense = np.zeros((B, cfg.dense_features), np.float32)
            cal = []
            for k in range(3):
                t1 = time.perf_counter()
                mgr.session("steady")._forward(
                    dense, probe[k * B:(k + 1) * B]).cpu()
                cal.append(time.perf_counter() - t1)
            view.flush()
            view.reset_stats()
            calib.update(cal=cal, t_b=float(np.mean(cal[1:])))
        taps, law = {}, {n: {"batches": 0, "queries": 0} for n in names}
        for name in names:
            tap = taps[name] = LookupTap(mgr.views[name])
            ns = shared.tenants[name]

            def hold(batch, scores, tap=tap,
                     tables=shared._tables[ns.start:ns.stop], name=name):
                indices, pooled = tap.last
                want = compact_bag_pooled(tables, indices,
                                          emb.kernel_opts())
                expect(failed, bool(torch.equal(pooled, want)),
                       f"{leg}: tenant {name} != its bag-kernel pooling "
                       f"on a batch of {len(batch)}")
                law[name]["batches"] += 1
                law[name]["queries"] += len(batch)
            mgr.session(name).server.on_batch = hold
        units = {n: len(shared._tenant_units(n)) for n in names}
        calib["spec"], qs = streams(calib["t_b"])
        kernel.LAUNCHES = fused.LAUNCHES = 0
        t1 = time.perf_counter()
        reports = replay_tenants(mgr, qs, window_queries=64)
        replay_s = time.perf_counter() - t1
        pct = mgr.percentiles()
        out = {"build_s": leg_build_s, "replay_s": replay_s,
               "units": units, "tenants": {}}
        for name in names:
            rep, tp, tap = reports[name], pct["tenants"][name], taps[name]
            expect(failed, all(r["fused"] == units[name]
                               for r in tap.records) and tap.records,
                   f"{leg}: tenant {name} fused launches per forward "
                   f"{sorted({r['fused'] for r in tap.records})}, "
                   f"{units[name]} units")
            expect(failed, law[name]["queries"] == rep.served,
                   f"{leg}: law held on {law[name]['queries']} of "
                   f"{rep.served} answers of {name}")
            lat = np.asarray(mgr.session(name).stats.batch_latencies_s)
            out["tenants"][name] = {
                "submitted": rep.submitted, "admitted": rep.admitted,
                "served": rep.served, "shed": rep.shed,
                "shed_frac": rep.shed_frac, "p50_ms": tp["p50_ms"],
                "p99_ms": tp["p99_ms"], "batches": len(lat),
                "mean_batch_ms": float(lat.mean() * 1e3),
                "fused_per_forward": units[name],
                "bag_launches": sum(r["bag"] for r in tap.records),
                "law": {**law[name], "equal": True}}
            tap.remove()
        if mgr.arbiter is not None:
            ev = mgr.arbiter.events
            conserved = all(sum(e["budgets"].values()) <= e["budget_bytes"]
                            for e in ev)
            splits = [(sum(e["budgets"].values()), e["budget_bytes"])
                      for e in ev]
            expect(failed, conserved and ev,
                   f"{leg}: arbiter rounds (split, budget) {splits}")
            out["arbiter"] = {
                "budget_target_bytes": built,
                "budget_fraction": arbiter.budget_fraction,
                "rounds": len(ev), "conserved": conserved,
                "budget_bytes": [e["budget_bytes"] for e in ev],
                "last_shares": mgr.arbiter.last_shares,
                "depths": [e["depths"] for e in ev]}
        out["fused_launches"] = fused.LAUNCHES
        out["bag_launches"] = kernel.LAUNCHES
        out["device_bytes"] = mgr.stats()["shared"]["device_bytes"]
        rss[leg] = host_rss_bytes()
        mgr.close()
        # the manager bound each tenant model to a view of its backend:
        # unbind them, or the closed backend's union stack stays alive
        for name, model in models.items():
            model.ebc.storage = own_storage[name]
        return out

    legs = {}
    for leg, scheduling in (("fair_arbiter", "fair"), ("fifo", "fifo")):
        t_leg = time.perf_counter()
        legs[leg] = run_leg(leg, scheduling)
        # the collections and their storages point at each other: gc
        # frees the leg's union stack and units before the next leg
        gc.collect()
        torch.cuda.empty_cache()
        rss[f"{leg}_freed"] = host_rss_bytes()
        legs[leg]["seconds"] = time.perf_counter() - t_leg
    del models
    gc.collect()
    fair = legs["fair_arbiter"]["tenants"]["steady"]["p99_ms"]
    fifo = legs["fifo"]["tenants"]["steady"]["p99_ms"]
    return dict(
        config="dlrm_production", backend="sharded (shared)",
        tenants={n: T for n in names}, rows=R, dim=D,
        pooling=L, shards=TENANT_SHARDS, max_batch=B, pad_to_max=False,
        reduced=reduced, ps_config=dataclasses.asdict(ps_cfg),
        calibration_batch_ms=[c * 1e3 for c in calib["cal"]],
        service_rate_qps=B / calib["t_b"], traffic=calib["spec"],
        legs=legs, steady_p99_fair_under_half_fifo=fair < 0.5 * fifo,
        steady_p99_ms={"fair_arbiter": fair, "fifo": fifo},
        host_rss_bytes=rss, host_available_bytes=avail, failed=failed)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--stop-after", default=None,
                        help="end the run after this phase")
    parser.add_argument("--geometry-sweep", action="store_true",
                        help="kernel_diag also times both kernels at each "
                             "of seven launch geometries")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    # 1. device
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         seconds=time.perf_counter() - t0)

    def stop(phase: str) -> bool:
        if args.stop_after == phase:
            emit("stopped", after=phase,
                 seconds=time.perf_counter() - t_all)
        return args.stop_after == phase

    # 2. build: one nvcc per library, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        infos = list(ex.map(lambda build: build(),
                            (kernel.build, fused.build)))
    libs = {}
    for lib, info in zip(("embedding_bag", "fused_lookup"), infos):
        libs[lib] = {
            "path": os.path.relpath(info["path"], ROOT),
            "nvcc_seconds": info["seconds"], "cached": info["cached"],
            "ptxas": [ln.strip() for ln in info["log"].splitlines()
                      if "registers" in ln or "spill" in ln]}
    emit("build", libraries=libs, seconds=time.perf_counter() - t0)
    if stop("build"):
        return 0

    # 3. parity
    t0 = time.perf_counter()
    parity = phase_parity()
    emit("parity", **parity, seconds=time.perf_counter() - t0)

    # 4. parity_fused
    t0 = time.perf_counter()
    parity_fused = phase_parity_fused()
    emit("parity_fused", **parity_fused, seconds=time.perf_counter() - t0)
    if stop("parity_fused"):
        return 0

    # 5. serve
    t0 = time.perf_counter()
    # shard_pad_tables pads 250 -> 256 tables for a 256-device slice; one
    # card holds whole tables, so no padding here
    emb = dataclasses.replace(CONFIG.embedding, shard_pad_tables=0)
    free, _total = torch.cuda.mem_get_info()
    per_table = emb.rows * emb.dim * emb.torch_dtype.itemsize
    fit = (free - HEADROOM_BYTES) // per_table
    cut = None
    if fit < emb.num_tables:
        cut = {"num_tables": [emb.num_tables, int(fit)],
               "reason": f"{free} bytes free on the card"}
        emb = dataclasses.replace(emb, num_tables=int(fit))
    cfg = dataclasses.replace(CONFIG, embedding=emb)
    T, R, L, D = emb.num_tables, emb.rows, emb.pooling, emb.dim
    B = 2048
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model = DLRM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    pattern = make_pattern("med_hot", R, seed=0)
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(B, cfg.dense_features)).astype(np.float32),
                sample_indices(pattern, B, T, L, seed=s))
               for s in range(SERVE_BATCHES)]
    sample_s = time.perf_counter() - t1

    scores = []
    kernel.LAUNCHES = 0
    sess = ServingSession(model, batcher=BatcherConfig(max_batch=B,
                                                       max_wait_s=0.0))
    sess.server.on_batch = lambda batch, s: scores.append(s.copy())
    for dense, idx in batches:
        sess.submit_batch(dense, idx)
    sess.drain(timeout_s=600.0)
    launches = kernel.LAUNCHES
    lat = np.asarray(sess.stats.batch_latencies_s) * 1e3
    forwards = 1 + len(lat)                       # warmup + served batches
    sess.close()
    check(len(lat) == SERVE_BATCHES and sess.stats.served == B * len(lat),
          f"served {sess.stats.served} queries in {len(lat)} batches")
    check(launches == forwards,
          f"kernel launched {launches} times over {forwards} forwards")
    logits = np.concatenate(scores)
    check(logits.shape == (B * SERVE_BATCHES,), f"logits {logits.shape}")
    check(bool(np.isfinite(logits).all()), "non-finite logits")

    # one 64-query sub-batch: kernel path vs the plain path on the card
    dense64 = torch.from_numpy(batches[0][0][:SUB_BATCH]).cuda()
    idx64 = torch.from_numpy(batches[0][1][:SUB_BATCH]).cuda()
    with torch.inference_mode():
        logits_k = model(dense64, idx64)
        pooled_k = model.ebc(idx64)
        rows = gather_rows(model.ebc.tables, idx64)       # [64, T, L, D]
        pooled_p = _pool_rows_core(rows, None, emb.combine)
        bound = 2 * ref.F32_EPS * rows.abs().sum(dim=2)
        del rows
        logits_p = model.forward_from_pooled(dense64, pooled_p)
    pooled_cmp = compare(pooled_k, pooled_p, bound,
                         "serve sub-batch pooled")
    torch.testing.assert_close(logits_k, logits_p, rtol=1e-4, atol=1e-4)
    check(bool(np.allclose(logits_k.cpu().numpy(), scores[0][:SUB_BATCH],
                           rtol=1e-4, atol=1e-4)),
          "session logits differ from a direct forward")
    emit("serve", config="dlrm_production", tables=T, rows=R, dim=D,
         pooling=L, batch=B, dtype=emb.dtype, cut=cut,
         batches=len(lat), batch_ms=lat.tolist(),
         p50_batch_ms=float(np.percentile(lat, 50)),
         p99_batch_ms=float(np.percentile(lat, 99)),
         kernel_launches=launches, forwards=forwards,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         table_bytes=emb.table_bytes(), init_s=init_s, sample_s=sample_s,
         logits_mean=float(logits.mean()), logits_std=float(logits.std()),
         sub_batch_pooled_max_abs_err=pooled_cmp["max_abs_err"],
         sub_batch_logits_max_abs_diff=(logits_k - logits_p).abs().max()
         .item(), logits_tolerance="rtol=1e-4 atol=1e-4",
         seconds=time.perf_counter() - t0)

    # 6. kernel time at the serve shape
    t0 = time.perf_counter()
    tables = model.ebc.tables
    idx_np = batches[0][1]
    t1 = time.perf_counter()
    idx = torch.from_numpy(idx_np).to("cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t1) * 1e3
    opts = emb.kernel_opts()
    run_kernel = lambda: kernel.embedding_bag_cuda(tables, idx, None, opts)
    ms = cuda_ms(run_kernel, iters=10, warmup=2)
    out_k = run_kernel()
    bag_info = kernel.last_launch_info()
    plain = lambda: torch.stack([ref.embedding_bag_ref(tables[t], idx[:, t])
                                 for t in range(T)], 1)
    plain_ms = cuda_ms(plain, iters=3)
    plain_err = (plain() - out_k).abs().max().item()
    flat = (idx.long() + torch.arange(T, device="cuda")[None, :, None] * R
            ).reshape(-1)
    offsets = torch.arange(0, flat.numel(), L, device="cuda")
    library = lambda: F.embedding_bag(flat, tables.view(-1, D), offsets,
                                      mode=emb.combine)
    library_ms = cuda_ms(library, iters=3)
    library_err = (library().view(B, T, D) - out_k).abs().max().item()
    del flat, offsets
    with torch.inference_mode():
        dense = torch.from_numpy(batches[0][0]).cuda()
        rest_ms = cuda_ms(lambda: model.forward_from_pooled(
            dense, out_k), iters=5)
    distinct = sum(int(torch.unique(idx[:, t]).numel()) for t in range(T))
    moved = distinct * D * 4 + idx.numel() * 4 + out_k.numel() * 4
    ops_count = B * T * L * D
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / F32_OPS_PER_S * 1e3
    all_lookups = B * T * L * D * 4
    emit("kernel_time", shape=[B, T, L, D], ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, library="torch.nn.functional.embedding_bag",
         plain_max_abs_diff=plain_err, library_max_abs_diff=library_err,
         distinct_rows=distinct, bytes_moved=moved,
         bound_ms=max(bytes_ms, ops_ms),
         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
         bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
         all_lookups_bytes=all_lookups,
         all_lookups_ms_at_peak=all_lookups / HBM_BYTES_PER_S * 1e3,
         fraction_of_bound=max(bytes_ms, ops_ms) / ms, **bag_info,
         breakdown_ms={"indices_to_device": h2d_ms, "embedding_kernel": ms,
                       "mlps_and_interaction": rest_ms,
                       "served_batch_p50": float(np.percentile(lat, 50))},
         seconds=time.perf_counter() - t0)

    del out_k, run_kernel, plain, library, dense
    if stop("kernel_time"):
        return 0

    # 6b. kernel_diag: the bag kernel on served, distinct and resident rows
    t0 = time.perf_counter()
    diag = phase_kernel_diag(tables, idx, pattern, opts, args.geometry_sweep)
    emit("kernel_diag", **diag, seconds=time.perf_counter() - t0)
    del tables, idx
    if stop("kernel_diag"):
        return 0

    # 6c. replay_device: the flash crowd and the SLO ladder on `device`
    t0 = time.perf_counter()
    replay_dev = phase_replay_device(model, pattern, batches[0])
    emit("replay_device", **replay_dev, seconds=time.perf_counter() - t0)
    check(not replay_dev["failed"], f"replay_device: {replay_dev['failed']}")
    if stop("replay_device"):
        return 0

    # 7. serve_tiered: the same weights and batches on the tiered backend
    t0 = time.perf_counter()
    n_tiered = SERVE_TIERED_BATCHES
    fields, sess, tiered, tiered_batches = phase_serve_tiered(
        model, batches[:n_tiered], logits[:B * n_tiered], deadline_s=600.0)
    del model
    emit("serve_tiered", **fields, seconds=time.perf_counter() - t0)

    # 8. kernel_time_fused, with the warm state serving left
    t0 = time.perf_counter()
    timed = phase_kernel_time_fused(sess, tiered, tiered_batches)
    sess.server.close()             # the storage serves replay_tiered next
    emit("kernel_time_fused", **timed, seconds=time.perf_counter() - t0)

    # 8b. replay_tiered: the ladder down to the degraded rung and back
    t0 = time.perf_counter()
    replay_tier = phase_replay_tiered(tiered, pattern, opts,
                                      tiered_batches[0])
    del sess, tiered, tiered_batches
    gc.collect()
    torch.cuda.empty_cache()
    emit("replay_tiered", **replay_tier, seconds=time.perf_counter() - t0)
    check(not replay_tier["failed"],
          f"replay_tiered: {replay_tier['failed']}")
    if stop("replay_tiered"):
        return 0

    # 8c. update: online model updates on `device`, `tiered` and `sharded`
    t0 = time.perf_counter()
    update = phase_update(cfg, pattern)
    emit("update", **update, seconds=time.perf_counter() - t0)
    check(not update["failed"], f"update: {update['failed']}")

    # 8d. serve_sharded: 4 shards, the law, a live migration
    t0 = time.perf_counter()
    sharded = phase_serve_sharded(cfg, pattern)
    emit("serve_sharded", **sharded, seconds=time.perf_counter() - t0)
    check(not sharded["failed"], f"serve_sharded: {sharded['failed']}")
    if stop("serve_sharded"):
        return 0

    # 8e. replay_tenants: two tenants on one shared sharded backend
    t0 = time.perf_counter()
    tenants = phase_replay_tenants(cfg, pattern)
    emit("replay_tenants", **tenants, seconds=time.perf_counter() - t0)
    check(not tenants["failed"], f"replay_tenants: {tenants['failed']}")
    if stop("replay_tenants"):
        return 0

    # 9. kernels
    def row(name, source, replaces, launches, max_abs_err, ms, plain_ms,
            bound_ms, bound_by, library_ms, info, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
                "registers": info["registers"],
                "blocks_per_sm": info["blocks_per_sm"],
                "fraction_of_bound": bound_ms / ms, **extra}
    csrc = "src/repro_torch/kernels/embedding_bag/csrc/"
    print(json.dumps({"kernels": [
        row("embedding_bag", csrc + "embedding_bag.cu",
            "src/repro/kernels/embedding_bag/kernel.py:194", launches,
            max(parity["max_abs_err_f32"], pooled_cmp["max_abs_err"]), ms,
            plain_ms, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", library_ms,
            bag_info,
            launches_tiered=fields["bag_kernel_launches"],
            launches_replay_device=replay_dev["bag_launches"],
            launches_replay_tiered=replay_tier["bag_launches"],
            launches_replay_tiered_degraded=replay_tier[
                "bag_launches_in_degraded"],
            launches_update_device=update["launches"]["device"]["bag"],
            launches_update_tiered=update["launches"]["tiered"]["bag"],
            launches_update_sharded=update["launches"]["sharded"]["bag"],
            launches_sharded=sharded["before_migration"]["bag_launches"],
            launches_sharded_migrated=sharded["after_migration"][
                "bag_launches"],
            launches_tenants={leg: out["bag_launches"] for leg, out in
                              tenants["legs"].items()}),
        row("fused_warm_lookup", csrc + "fused_lookup.cu",
            "src/repro/kernels/embedding_bag/fused.py:266",
            fields["fused_launches"],
            max(parity_fused["max_abs_err_f32"], timed["plain_max_abs_err"]),
            timed["ms"], timed["plain_ms"], timed["bound_ms"],
            timed["bound_by"], timed["library_ms"], timed,
            pool_pass_ms=timed["pool_pass_ms"],
            list_pass_ms=timed["list_pass_ms"],
            launches_replay_tiered=replay_tier["fused_launches"],
            launches_update=update["launches"]["tiered"]["fused"],
            launches_update_sharded=update["launches"]["sharded"]["fused"],
            launches_sharded=sharded["before_migration"]["fused_launches"],
            launches_sharded_migrated=sharded["after_migration"][
                "fused_launches"],
            launches_tenants={leg: out["fused_launches"] for leg, out in
                              tenants["legs"].items()})]}),
          flush=True)
    emit("done", seconds=time.perf_counter() - t_all)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
