"""The hotness traffic of the paper's Table III, drawn on the device.

A frozen copy of the port's calibration (`repro_torch/core/access_patterns`
at the commit that added this benchmark): a finite-support Zipf(alpha) over
each table's rows, alpha bisected so that the expected share of distinct
rows matches the paper's target for the reference workload (500,000 rows,
2048 x 150 lookups a table), and a rank -> row permutation for each table,
so hot rows are scattered as in a real table. `random` is uniform.

The yardstick lives here and not in the program, so that a later change to
the program cannot move it. The sampler is rewritten in torch so that a pool
of batches of 76.8 M lookups each is drawn on the card in seconds.
"""
from __future__ import annotations

import numpy as np
import torch

# Paper Table III: unique access % under the reference workload
PAPER_UNIQUE_PCT = {
    "one_item": 0.0002,
    "high_hot": 4.05,
    "med_hot": 20.50,
    "low_hot": 46.21,
    "random": 63.21,
}
REF_ROWS = 500_000
REF_ACCESSES = 2048 * 150


def expected_unique_pct(num_rows: int, alpha: float, accesses: int) -> float:
    """E[distinct rows touched] / num_rows * 100 under Zipf(alpha):
    sum_r 1 - (1 - p_r)^A, in log space."""
    ranks = np.arange(1, num_rows + 1, dtype=np.float64)
    w = ranks ** (-alpha) if alpha > 0 else np.ones_like(ranks)
    p = w / w.sum()
    log1mp = np.log1p(-np.minimum(p, 1 - 1e-15))
    return float(np.sum(-np.expm1(accesses * log1mp))) * 100.0 / num_rows


def calibrate_alpha(target_pct: float, num_rows: int = REF_ROWS,
                    accesses: int = REF_ACCESSES) -> float:
    """The Zipf exponent whose expected unique % is `target_pct` (bisection;
    targets above uniform's bound are clamped to 0.98 of it)."""
    target_pct = min(target_pct,
                     0.98 * expected_unique_pct(num_rows, 0.0, accesses))
    lo, hi = 0.0, 4.0
    if expected_unique_pct(num_rows, lo, accesses) <= target_pct:
        return lo
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if expected_unique_pct(num_rows, mid, accesses) > target_pct:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


class HotnessSampler:
    """Index batches [B, T, L] int32 in [0, rows) on `generator`'s device.

    `alpha` 0 draws uniform rows; otherwise ranks are drawn by inverse CDF
    from Zipf(alpha) over `rows` ranks and mapped to rows by each table's
    own permutation, drawn from the same generator."""

    def __init__(self, *, tables: int, rows: int, alpha: float,
                 generator: torch.Generator):
        self.tables, self.rows, self.alpha = tables, rows, float(alpha)
        self.gen = generator
        dev = generator.device
        self.cdf = self.perms = None
        if self.alpha > 0:
            w = torch.arange(1, rows + 1, dtype=torch.float64,
                             device=dev).pow_(-self.alpha)
            cdf = torch.cumsum(w, 0)
            self.cdf = cdf / cdf[-1]
            self.perms = torch.stack([
                torch.randperm(rows, generator=generator, device=dev,
                               dtype=torch.int32) for _ in range(tables)])

    def sample(self, batch: int, pooling: int) -> torch.Tensor:
        shape = (batch, self.tables, pooling)
        dev = self.gen.device
        if self.alpha == 0:
            return torch.randint(0, self.rows, shape, generator=self.gen,
                                 device=dev, dtype=torch.int32)
        u = torch.rand(shape, generator=self.gen, device=dev,
                       dtype=torch.float64)
        ranks = torch.searchsorted(self.cdf, u).clamp_max_(self.rows - 1)
        del u
        return torch.gather(self.perms.unsqueeze(0).expand(batch, -1, -1),
                            2, ranks).to(torch.int32)


def distinct_rows(indices: torch.Tensor, rows: int) -> int:
    """Distinct (table, row) pairs of one batch [B, T, L]: what the
    embedding stage must read from memory at least once."""
    t = torch.arange(indices.shape[1], device=indices.device,
                     dtype=torch.int64)[None, :, None]
    return int(torch.unique(indices.long() + t * rows).numel())
