"""The plain version of the exact top-K scan (`csrc/mips_topk.cu`).

The kernel scores a row against a query by fmaf over the dims in order,
from 0, one float32 rounding a step. Here the same steps are taken in
float64, where the product of a float32 query entry and a bf16 (or
float32) row entry is exact, and each sum is rounded to float32, so that
the scores are the kernel's bit for bit. The K best a query, by score
descending and then row ascending, are kept in blocks of rows: the running
K and the block's rows, cut by `torch.topk`'s K-th value (ties at it kept)
and put in order by a stable sort on the row, then on the score.
`kernel.mips_topk` takes it for CPU tensors only; it runs on any device
when called directly (chip_smoke.py holds the kernel to it on the card).
"""
from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 20       # rows scored at a time


def scores_ref(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """queries [U, d] float32, rows [n, d] -> [U, n] float32: fmaf over d in
    order, each step rounded to float32."""
    q = queries.double()
    acc = torch.zeros((queries.shape[0], rows.shape[0]), dtype=torch.float64,
                      device=rows.device)
    for d in range(rows.shape[1]):
        acc.addcmul_(q[:, d:d + 1], rows[:, d].double()[None, :])
        acc.copy_(acc.float())
    return acc.float()


def best_of(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """The k best of one query's (scores [n], ids [n] int64): score
    descending, then id ascending."""
    keep = scores >= torch.topk(scores, k).values[-1]
    scores, ids = scores[keep], ids[keep]
    order = torch.argsort(ids)
    scores, ids = scores[order], ids[order]
    order = torch.argsort(scores, descending=True, stable=True)[:k]
    return scores[order], ids[order]


def mips_topk_ref(queries: torch.Tensor, rows: torch.Tensor, k: int,
                  block_rows: int = BLOCK_ROWS):
    """queries [U, d] float32, rows [R, d], k <= R -> (ids [U, k] int32,
    scores [U, k] float32), best first."""
    users = queries.shape[0]
    device = rows.device
    best_s = [torch.empty(0, device=device) for _ in range(users)]
    best_i = [torch.empty(0, dtype=torch.int64, device=device)
              for _ in range(users)]
    for r0 in range(0, rows.shape[0], block_rows):
        block = rows[r0:r0 + block_rows]
        s = scores_ref(queries.to(device), block)
        ids = torch.arange(r0, r0 + block.shape[0], device=device)
        for u in range(users):
            cand_s = torch.cat([best_s[u], s[u]])
            best_s[u], best_i[u] = best_of(
                cand_s, torch.cat([best_i[u], ids]), min(k, cand_s.numel()))
    return (torch.stack(best_i).to(torch.int32), torch.stack(best_s))
