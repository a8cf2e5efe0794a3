"""Quickstart: the paper's technique in 30 lines — the port's counterpart
of the JAX package's `examples/quickstart.py`, with its sizes.

Builds a small embedding stage, profiles a trace, plans the hot-row
cache (L2 pinning), and runs the pinned, hot-first lookup (the CUDA
embedding-bag kernel with its hot operand) against the plain gather.

    python -m repro_torch.examples.quickstart [--device cuda|cpu]

`--device cuda` (the default) needs a card; `--device cpu` runs the
kernel's plain version. Run from a checkout with `src` on the path
(`PYTHONPATH=src`).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import (EmbeddingBagCollection, EmbeddingStageConfig,
                              make_pattern, plan_embedding_stage,
                              plan_from_trace)
from repro_torch.core.embedding import _pool_rows_core, gather_rows
from repro_torch.utils import resolve_device

ROWS, DIM, TABLES, POOL, BATCH = 20_000, 128, 4, 16, 64
MAX_ERR = 1e-4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernel) or cpu (plain)")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. a production-like skewed access trace (paper §III-B "high hot")
    pattern = make_pattern("high_hot", ROWS, seed=0)
    trace = pattern.sample(BATCH, POOL, seed=0)

    # 2. the static profiling framework (paper §VII) picks the knobs
    report = plan_embedding_stage(trace, ROWS, DIM)
    print(f"planner: pin {report.pinned_rows} rows "
          f"(covers {report.hot_coverage_at_k:.0%} of accesses), "
          f"prefetch distance {report.prefetch_distance}")

    # 3. baseline: the plain gather over the collection's tables
    base_cfg = EmbeddingStageConfig(num_tables=TABLES, rows=ROWS, dim=DIM,
                                    pooling=POOL)
    gen = torch.Generator(device=device).manual_seed(0)
    ebc = EmbeddingBagCollection(base_cfg, device=device, generator=gen)
    idx_np = np.stack([pattern.sample(BATCH, POOL, seed=t)
                       for t in range(TABLES)], axis=1)
    indices = torch.from_numpy(idx_np).to(device)
    with torch.no_grad():
        baseline = _pool_rows_core(gather_rows(ebc.tables, indices), None,
                                   base_cfg.combine)

    # 4. optimized: hot-first tables, the pinned rows through the kernel's
    #    hot operand, the planned ring depth
    opt_cfg = dataclasses.replace(
        base_cfg, pinned_rows=report.pinned_rows,
        prefetch_distance=report.prefetch_distance)
    plans = [plan_from_trace(idx_np[:, t], ROWS, report.pinned_rows)
             for t in range(TABLES)]
    hot_first = torch.stack([plan.reorder_table(ebc.tables[t])
                             for t, plan in enumerate(plans)])
    ebc_opt = EmbeddingBagCollection(opt_cfg, plans, device=device,
                                     tables=hot_first)
    with torch.no_grad():
        optimized = ebc_opt(indices)

    err = float((optimized - baseline).abs().max())
    print(f"pinned hot-first output matches baseline: max|err| = {err:.2e}")
    if not err < MAX_ERR:
        raise RuntimeError(f"max|err| {err:.3e} >= {MAX_ERR}")
    print("OK")
    return {"report": report, "max_abs_err": err}


if __name__ == "__main__":
    main()
