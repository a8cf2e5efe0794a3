#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs a GPU

Phases, each printing one JSON line and its seconds; any failure raises
and the script exits non-zero:

  1. device       card name, power limit, TF32 off for matmul and cuDNN
  2. build        the CUDA embedding-bag kernel, from the sources here
  3. parity       kernel vs its plain version (ref.embedding_bag_ref) on the
                  card: sum/mean, weights on/off, num_hot 0/>0, f32/bf16,
                  ragged B, vector and scalar D, out-of-range indices, and
                  one table at the serve shape (R=500K, B=2048, L=150, D=128)
  4. serve        dlrm_production at full width through ServingSession on
                  the `device` backend: 3 batches of 2048 med_hot queries;
                  the kernel launches once per forward; a 64-query
                  sub-batch's logits match the plain path
  5. kernel_time  kernel, plain version and torch's embedding_bag at the
                  serve shape (CUDA events), the memory bound, and a
                  breakdown of one batch's time
  6. kernels      one line per ported kernel (the PERF.md row)

The last line is {"ok": true, "device": {...}}. There is no CPU branch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.dlrm_production import CONFIG  # noqa: E402
from repro_torch.core.access_patterns import make_pattern  # noqa: E402
from repro_torch.core.embedding import _pool_rows_core, gather_rows  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel, ops, ref  # noqa: E402
from repro_torch.models import DLRM  # noqa: E402
from repro_torch.serving import BatcherConfig, ServingSession  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM data sheet, f32 outside tensor cores
SERVE_BATCHES = 3
SUB_BATCH = 64
# device bytes kept free beside the tables: a batch's indices, interaction
# and MLP activations, the sub-batch's plain gather, the timing phase's
# flattened indices
HEADROOM_BYTES = 8 * 10**9


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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
        name = (f"{str(dtype)[6:]} D={dim} L={pooling} {mode} "
                f"w={int(weighted)} hot={num_hot} pd={pd} bb={bb} B={batch}"
                + (" bad_rows" if bad_rows else ""))
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
    f32 = [r for r in results if not r["case"].startswith("bfloat16")]
    return {"cases": len(results),
            "max_abs_err_f32": max(r["max_abs_err"] for r in f32),
            "max_err_over_bound": max(r["max_err_over_bound"]
                                      for r in results),
            "results": results}


def main() -> int:
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

    # 2. build
    t0 = time.perf_counter()
    info = kernel.build()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", path=os.path.relpath(info["path"], ROOT),
         nvcc_seconds=info["seconds"], cached=info["cached"],
         ptxas=ptxas, seconds=time.perf_counter() - t0)

    # 3. parity
    t0 = time.perf_counter()
    parity = phase_parity()
    emit("parity", **parity, seconds=time.perf_counter() - t0)

    # 4. serve
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

    # 5. kernel time at the serve shape
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
         fraction_of_bound=max(bytes_ms, ops_ms) / ms,
         breakdown_ms={"indices_to_device": h2d_ms, "embedding_kernel": ms,
                       "mlps_and_interaction": rest_ms,
                       "served_batch_p50": float(np.percentile(lat, 50))},
         seconds=time.perf_counter() - t0)

    # 6. kernels
    print(json.dumps({"kernels": [{
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:194",
        "launches": launches,
        "max_abs_err": max(parity["max_abs_err_f32"],
                           pooled_cmp["max_abs_err"]),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms}]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_all)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
