"""HSTU generative retrieval (Zhai et al., arXiv:2402.17152, §2.1) in plain
PyTorch, each user alone.

A user's history (each engagement's item row and action row, in order, at
the engagement's time) goes through HSTU's layers as `bench/reference/
hstu.py` computes them (`user_states`, no candidates); the query is the
last action token's state over its L2 norm; every item row, widened to
float32, is scored by a product with it, in blocks of rows beside the
table, and the K best a user are kept: the running K and the block's
scores cut by `torch.topk`'s K-th value (ties at it kept), then a stable
sort by row and then by score, descending, so that ties go to the smaller
row. It imports nothing of the program under test.

Float32 with TF32 off. `lower=True` is the control, one precision step
below what the configuration states: `hstu.py`'s control for the encoder
(products in TF32, each layer's input and attention output rounded to
bfloat16), the query rounded to bfloat16, and the scan's products in TF32.
"""
from __future__ import annotations

import torch

from . import hstu

BLOCK_ROWS = 1 << 20       # item rows scored at a time


def best_of(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """The k best of (scores [n], ids [n]): score descending, then id
    ascending."""
    keep = scores >= torch.topk(scores, k).values[-1]
    scores, ids = scores[keep], ids[keep]
    order = torch.argsort(ids)
    scores, ids = scores[order], ids[order]
    order = torch.argsort(scores, descending=True, stable=True)[:k]
    return scores[order], ids[order]


def top_k(queries: torch.Tensor, items: torch.Tensor, k: int):
    """queries [U, d] float32, items [R, d] -> (ids [U, k] int64, scores
    [U, k] float32), best first."""
    device = items.device
    best = [(torch.empty(0, device=device),
             torch.empty(0, dtype=torch.int64, device=device))
            for _ in range(queries.shape[0])]
    for r0 in range(0, items.shape[0], BLOCK_ROWS):
        block = items[r0:r0 + BLOCK_ROWS].float()
        scores = queries @ block.T
        del block
        ids = torch.arange(r0, r0 + scores.shape[1], device=device)
        for u, (s, i) in enumerate(best):
            cand = torch.cat([s, scores[u]])
            best[u] = best_of(cand, torch.cat([i, ids]),
                              min(k, cand.numel()))
    return (torch.stack([i for _, i in best]),
            torch.stack([s for s, _ in best]))


def retrieve(tables: torch.Tensor, layers, cfg: dict, events,
             item_ids: torch.Tensor, action_ids: torch.Tensor,
             timestamps: torch.Tensor, lower: bool = False):
    """tables [item_rows + action_rows, d] (items, then actions); events,
    a count a user; item_ids, action_ids, timestamps [E] (every user's
    engagements in user order) -> (the last layer's states [2E, d], every
    user's history rows; ids [U, K]; scores [U, K], best first), K =
    cfg["retrieve_k"]."""
    items = tables[:cfg["item_rows"]]
    actions = tables[cfg["item_rows"]:]
    states = torch.empty((2 * sum(events), tables.shape[1]),
                         dtype=torch.float32, device=tables.device)
    queries, e0 = [], 0
    with hstu.matmul_precision(lower):
        for e in events:
            ev = slice(e0, e0 + e)
            x = torch.stack([items[item_ids[ev].long()],
                             actions[action_ids[ev].long()]],
                            dim=1).reshape(2 * e, -1).float()
            out = hstu.user_states(x, timestamps[ev].repeat_interleave(2),
                                   layers, cfg, 2 * e, lower)
            states[2 * e0:2 * (e0 + e)] = out
            queries.append(out[-1] / out[-1].norm())
            e0 += e
        queries = torch.stack(queries)
        if lower:
            queries = queries.to(torch.bfloat16).float()
        ids, scores = top_k(queries, items, cfg["retrieve_k"])
    return states, ids, scores
