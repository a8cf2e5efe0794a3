"""Hotness dataset family + access-pattern metrics (paper §III-B, Table III, Fig. 5).

The paper classifies embedding access patterns by "hotness": one_item,
high_hot, med_hot, low_hot, random — production-trace-derived distributions
with unique-access% of {0.0002, 4.05, 20.5, 46.21, 63.21} for a 500K-row
table under batch=2048 x pooling=150 accesses.

We regenerate the same family synthetically with Zipf(alpha) samplers whose
alpha is calibrated so the *expected unique-access%* matches the paper's
target for the reference workload, then reuse those alphas at any scale.
`one_item` is the degenerate all-same-row pattern and `random` is uniform.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np

# Paper Table III targets (unique access %, reference workload).
PAPER_UNIQUE_PCT: Dict[str, float] = {
    "one_item": 0.0002,
    "high_hot": 4.05,
    "med_hot": 20.50,
    "low_hot": 46.21,
    "random": 63.21,
}
HOTNESS_LEVELS = tuple(PAPER_UNIQUE_PCT)

# Reference workload from paper §V: 500K rows, batch 2048, pooling 150.
REF_ROWS = 500_000
REF_ACCESSES = 2048 * 150


@dataclasses.dataclass(frozen=True)
class AccessPattern:
    """A synthetic categorical-feature access distribution over a table."""

    hotness: str
    num_rows: int
    alpha: float  # Zipf exponent; 0.0 => uniform; inf semantics for one_item
    seed: int = 0

    def probs(self) -> np.ndarray:
        """Per-row access probability (rank-ordered, rank 0 hottest)."""
        if self.hotness == "one_item":
            p = np.zeros(self.num_rows)
            p[0] = 1.0
            return p
        ranks = np.arange(1, self.num_rows + 1, dtype=np.float64)
        w = ranks ** (-self.alpha) if self.alpha > 0 else np.ones_like(ranks)
        return w / w.sum()

    def rank_to_row(self) -> np.ndarray:
        """Scatter ranks to random physical rows (hot rows are NOT contiguous,
        as in real tables) so that hot-first remapping is non-trivial."""
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        return rng.permutation(self.num_rows).astype(np.int64)

    def sample(self, batch: int, pooling: int, seed: int = 0) -> np.ndarray:
        """Sample an [batch, pooling] int32 index matrix."""
        rng = np.random.default_rng((self.seed << 16) ^ seed)
        n = batch * pooling
        if self.hotness == "one_item":
            ranks = np.zeros(n, dtype=np.int64)
        elif self.alpha == 0.0:
            ranks = rng.integers(0, self.num_rows, size=n)
        else:
            ranks = _zipf_sample(rng, self.num_rows, self.alpha, n)
        rows = self.rank_to_row()[ranks]
        return rows.reshape(batch, pooling).astype(np.int32)


def _zipf_sample(rng: np.random.Generator, n_rows: int, alpha: float,
                 n: int) -> np.ndarray:
    """Inverse-CDF Zipf sampling over a finite support (vectorized)."""
    ranks = np.arange(1, n_rows + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    u = rng.random(n)
    return np.searchsorted(cdf, u, side="left")


def expected_unique_pct(num_rows: int, alpha: float, accesses: int) -> float:
    """E[#unique rows touched] / num_rows * 100 under Zipf(alpha).

    E[unique] = sum_r 1 - (1 - p_r)^A, computed in log-space for stability.
    """
    if alpha == float("inf"):
        return 100.0 / num_rows
    ranks = np.arange(1, num_rows + 1, dtype=np.float64)
    w = ranks ** (-alpha) if alpha > 0 else np.ones_like(ranks)
    p = w / w.sum()
    log1mp = np.log1p(-np.minimum(p, 1 - 1e-15))
    e_unique = float(np.sum(-np.expm1(accesses * log1mp)))
    return e_unique * 100.0 / num_rows


@functools.lru_cache(maxsize=None)
def calibrate_alpha(target_unique_pct: float, num_rows: int = REF_ROWS,
                    accesses: int = REF_ACCESSES) -> float:
    """Bisect the Zipf exponent so expected unique%% hits the paper target.

    Uniform sampling bounds the achievable unique%% from above (~45.9%% at the
    reference workload); the paper's low_hot figure (46.21%%, averaged over
    100 trace windows) slightly exceeds it, so targets are clamped just under
    the uniform bound to keep the hotness ordering strict.
    """
    uniform_pct = expected_unique_pct(num_rows, 0.0, accesses)
    target_unique_pct = min(target_unique_pct, 0.98 * uniform_pct)
    lo, hi = 0.0, 4.0  # unique% is monotone-decreasing in alpha
    if expected_unique_pct(num_rows, lo, accesses) <= target_unique_pct:
        return lo
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if expected_unique_pct(num_rows, mid, accesses) > target_unique_pct:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def make_pattern(hotness: str, num_rows: int, seed: int = 0) -> AccessPattern:
    if hotness not in PAPER_UNIQUE_PCT:
        raise ValueError(f"unknown hotness {hotness!r}; want one of {HOTNESS_LEVELS}")
    if hotness == "one_item":
        return AccessPattern("one_item", num_rows, alpha=float("inf"), seed=seed)
    if hotness == "random":
        return AccessPattern("random", num_rows, alpha=0.0, seed=seed)
    alpha = calibrate_alpha(PAPER_UNIQUE_PCT[hotness])
    return AccessPattern(hotness, num_rows, alpha=alpha, seed=seed)


# ---------------------------------------------------------------------------
# Metrics (paper §III-B)
# ---------------------------------------------------------------------------

def unique_access_pct(indices: np.ndarray, num_rows: int) -> float:
    """Paper's `unique access %` = 100 * U / R."""
    return len(np.unique(indices)) * 100.0 / num_rows


def coverage_curve(indices: np.ndarray, points: int = 100) -> np.ndarray:
    """Paper Fig. 5: % of total accesses covered by top-x% of unique rows.

    Returns [points, 2] array of (unique_pct, covered_access_pct).
    """
    flat = indices.reshape(-1)
    _, counts = np.unique(flat, return_counts=True)
    counts = np.sort(counts)[::-1]
    cum = np.cumsum(counts) / flat.size * 100.0
    xs = np.linspace(1, len(counts), points).astype(np.int64)
    return np.stack([xs / len(counts) * 100.0, cum[xs - 1]], axis=1)


def hot_coverage(indices: np.ndarray, hot_rows: np.ndarray) -> float:
    """Fraction of accesses served by a given hot-row set (exact 'hit rate')."""
    flat = indices.reshape(-1)
    return float(np.isin(flat, hot_rows).mean())
