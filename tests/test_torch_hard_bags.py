"""The summation's hard bags, which `chip_smoke.py`'s parity, parity_fused
and ragged phases pool through the three bag kernels on the card and hold
to their exact sums at `ref.summation_bound` (2·eps·Σ|w·x|).

Here on the CPU: the bags the phases draw (L = 150 copies of one
all-positive row; L = 257 rows of magnitudes 1e-3 to 1e3), the exact sum
they are compared with, and the kernels' compensated add
(`bag_common.cuh` `add_compensated`, Kahan's recurrence, folded as s - c)
emulated step by step in float32: it meets the rule on every hard bag,
where a plain float32 chain of the repeats breaks it."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.kernels.embedding_bag import ref  # noqa: E402

ROWS, BATCH, DIM = 1000, 13, 128


def _kahan(rows, w=None):
    """[B, L, D] float32 rows (and [B, L] weights) -> ([B, D] sums, [B]
    weight sums) by the kernels' recurrence, one float32 operation a step:
    the product w·x rounded once, then y = x - c; t = s + y;
    c = (t - s) - y; s = t; the result s - c."""
    def add(s, c, x):
        y = x - c
        t = s + y
        return t, (t - s) - y
    s = c = torch.zeros(rows.shape[0], rows.shape[2])
    ws = wc = torch.zeros(rows.shape[0])
    for q in range(rows.shape[1]):
        x = rows[:, q] if w is None else rows[:, q] * w[:, q, None]
        s, c = add(s, c, x)
        if w is not None:
            ws, wc = add(ws, wc, w[:, q])
    return s - c, ws - wc


def _plain_chain(rows):
    """A plain float32 sum in lookup order, one add a step."""
    s = torch.zeros(rows.shape[0], rows.shape[2])
    for q in range(rows.shape[1]):
        s = s + rows[:, q]
    return s


def _hard_bags(seed, table, pooling, repeat):
    gen = torch.Generator().manual_seed(seed)
    tab = chip_smoke._hard_tables(gen, 2, ROWS, DIM)[table]
    idx = chip_smoke._hard_indices(gen, BATCH, 1, ROWS, pooling, repeat)[:, 0]
    return gen, tab, idx


def test_hard_tables_and_indices():
    gen = torch.Generator().manual_seed(0)
    tab = chip_smoke._hard_tables(gen, 2, ROWS, DIM)
    assert tab.dtype == torch.float32 and tab.shape == (2, ROWS, DIM)
    assert float(tab[0].min()) >= 0.5 and float(tab[0].max()) < 1.5
    scale = tab[1].abs().amax(dim=1)
    assert float(scale.min()) < 1e-2 and float(scale.max()) > 1e2
    assert float(scale.max()) < 1e3 * 6   # randn past 6 sigma: never
    rep = chip_smoke._hard_indices(gen, BATCH, 2, ROWS, 150, True)
    assert rep.shape == (BATCH, 2, 150) and rep.dtype == torch.int32
    assert bool((rep == rep[..., :1]).all())
    uni = chip_smoke._hard_indices(gen, BATCH, 2, ROWS, 257, False)
    assert int(uni.min()) >= 0 and int(uni.max()) < ROWS
    assert len(torch.unique(uni)) > 1


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", True),
                                           ("mean", False)])
def test_exact_bags_match_the_plain_version(mode, weighted):
    gen, tab, idx = _hard_bags(1, 1, 257, False)
    w = torch.rand(idx.shape, generator=gen) if weighted else None
    got = chip_smoke._exact_bags(tab, idx, w, mode)
    assert got.dtype == torch.float64
    want = ref.embedding_bag_ref(tab.double(), idx,
                                 None if w is None else w.double(), mode)
    # f64 sums of the same terms agree to f64 rounding; where weighted,
    # each f32 product w·x is rounded once, by at most eps/2 of the term
    bound = ref.summation_bound(tab, idx, w, mode).double()
    slack = bound / 4 if weighted else 1e-6 * bound
    assert bool(((got - want).abs() <= slack).all())


@pytest.mark.parametrize("table,pooling,repeat", [
    (0, chip_smoke.HARD_REPEAT_L, True), (1, chip_smoke.HARD_REPEAT_L, True),
    (0, chip_smoke.HARD_MIXED_L, False), (1, chip_smoke.HARD_MIXED_L, False)])
@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", True)])
def test_kahan_recurrence_meets_the_rule(table, pooling, repeat, mode,
                                         weighted):
    gen, tab, idx = _hard_bags(2 + table, table, pooling, repeat)
    w = torch.rand(idx.shape, generator=gen) if weighted else None
    sums, wsum = _kahan(tab[idx.long()], w)
    if mode == "mean":
        sums = sums / (wsum.clamp_min(1e-9)[:, None] if weighted
                       else torch.tensor(float(pooling)))
    err = (sums.double() - chip_smoke._exact_bags(tab, idx, w, mode)).abs()
    share = err / ref.summation_bound(tab, idx, w, mode).double()
    # the rule, with room: Kahan's sum is within (2u + O(L·u²))·Σ|w·x|
    assert float(share.max()) < 0.6


def test_plain_chain_breaks_the_rule_on_repeats():
    gen, tab, idx = _hard_bags(4, 0, chip_smoke.HARD_REPEAT_L, True)
    err = (_plain_chain(tab[idx.long()]).double()
           - chip_smoke._exact_bags(tab, idx)).abs()
    assert float((err / ref.summation_bound(tab, idx).double()).max()) > 1.0
