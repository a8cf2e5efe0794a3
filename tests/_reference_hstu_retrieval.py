"""HSTU generative retrieval (Zhai et al., arXiv:2402.17152, §2.1) in plain
PyTorch: the yardstick of the port's CPU tests
(`tests/test_torch_hstu_retrieval.py`).

Each user's history alone goes through HSTU's layers (`_reference_hstu.
user_states`, no candidates); the query is the last action token's state
over its L2 norm; every item row, widened to float32, is scored by a
product with it, in blocks of rows, and the K best a user are kept: the
running K and the block's scores cut by `torch.topk`'s K-th value (ties at
it kept), then a stable sort by row and then by score, descending, so that
ties go to the smaller row.

Float32 with TF32 off, no kernel and no batching; it imports nothing of
`repro` or `repro_torch`.
"""
from __future__ import annotations

import torch

import _reference_hstu as hstu

BLOCK_ROWS = 1 << 16       # item rows scored at a time


def best_of(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """The k best of (scores [n], ids [n]): score descending, then id
    ascending."""
    keep = scores >= torch.topk(scores, k).values[-1]
    scores, ids = scores[keep], ids[keep]
    order = torch.argsort(ids)
    scores, ids = scores[order], ids[order]
    order = torch.argsort(scores, descending=True, stable=True)[:k]
    return scores[order], ids[order]


def top_k(queries: torch.Tensor, items: torch.Tensor, k: int,
          block_rows: int = BLOCK_ROWS):
    """queries [U, d] float32, items [R, d] -> (ids [U, k] int64, scores
    [U, k] float32), best first."""
    best = [(torch.empty(0), torch.empty(0, dtype=torch.int64))
            for _ in range(queries.shape[0])]
    with hstu.matmul_precision(False):
        for r0 in range(0, items.shape[0], block_rows):
            block = items[r0:r0 + block_rows].float()
            scores = queries @ block.T
            ids = torch.arange(r0, r0 + block.shape[0])
            for u, (s, i) in enumerate(best):
                cand = torch.cat([s, scores[u]])
                best[u] = best_of(cand, torch.cat([i, ids]),
                                  min(k, cand.numel()))
    return (torch.stack([i for _, i in best]),
            torch.stack([s for s, _ in best]))


def retrieve(tables: torch.Tensor, layers, cfg: dict, events,
             item_ids: torch.Tensor, action_ids: torch.Tensor,
             timestamps: torch.Tensor, k: int):
    """tables [item_rows + action_rows, d] (items, then actions); events,
    a count a user; item_ids, action_ids, timestamps [E] (every user's
    engagements in user order) -> (the last layer's states [2E, d], every
    user's history rows; ids [U, k]; scores [U, k]; queries [U, d])."""
    items = tables[:cfg["item_rows"]]
    actions = tables[cfg["item_rows"]:]
    states, queries, e0 = [], [], 0
    with hstu.matmul_precision(False):
        for e in events:
            ev = slice(e0, e0 + e)
            x = torch.stack([items[item_ids[ev].long()],
                             actions[action_ids[ev].long()]],
                            dim=1).reshape(2 * e, -1).float()
            out = hstu.user_states(x, timestamps[ev].repeat_interleave(2),
                                   layers, cfg, 2 * e)
            states.append(out)
            queries.append(out[-1] / out[-1].norm())
            e0 += e
    queries = torch.stack(queries)
    ids, scores = top_k(queries, items, k)
    return torch.cat(states), ids, scores, queries
