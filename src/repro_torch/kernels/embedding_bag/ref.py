"""Plain PyTorch versions of the embedding-bag gather-reduce (paper Algorithm 1).

The semantic ground truth the CUDA kernel is held to (`chip_smoke.py` on
the card, the CPU tests through `ops`), with the semantics of
`repro/kernels/embedding_bag/ref.py`: a weighted mean divides by
`max(sum(w), 1e-9)`, an unweighted one by the pooling factor L.
"""
from __future__ import annotations

import torch

F32_EPS = float(torch.finfo(torch.float32).eps)


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      mode: str = "sum") -> torch.Tensor:
    """Fixed-pooling embedding bag.

    table:   [R, D] float
    indices: [B, L] int
    weights: [B, L] float or None (per-lookup scale; also used as mask)
    returns: [B, D] (sum or mean over L)
    """
    rows = table[indices.long()]                         # [B, L, D]
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    out = rows.sum(dim=1)
    if mode == "mean":
        if weights is not None:
            denom = weights.sum(dim=1).clamp_min(1e-9)[..., None]
        else:
            denom = indices.shape[1]
        out = out / denom
    elif mode != "sum":
        raise ValueError(f"unknown mode {mode!r}")
    return out


def embedding_bag_ragged_ref(table: torch.Tensor, flat_indices: torch.Tensor,
                             offsets: torch.Tensor,
                             weights: torch.Tensor | None = None,
                             mode: str = "sum") -> torch.Tensor:
    """Ragged embedding bag (offsets form, like torch EmbeddingBag).

    flat_indices: [N] int, offsets: [B+1] int. Bag b covers
    flat_indices[offsets[b]:offsets[b+1]].
    """
    num_bags = offsets.shape[0] - 1
    rows = table[flat_indices.long()]                    # [N, D]
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    seg = torch.searchsorted(offsets[1:].contiguous(),
                             torch.arange(flat_indices.shape[0],
                                          device=offsets.device),
                             right=True)
    out = torch.zeros((num_bags, table.shape[1]), dtype=rows.dtype,
                      device=rows.device).index_add_(0, seg, rows)
    if mode == "mean":
        counts = (offsets[1:] - offsets[:-1]).to(out.dtype)
        out = out / counts.clamp_min(1)[:, None]
    elif mode != "sum":
        raise ValueError(f"unknown mode {mode!r}")
    return out


def ragged_tables_bag_ref(tables: torch.Tensor, indices: torch.Tensor,
                          row_offsets, col_offsets) -> torch.Tensor:
    """Sum-pooled bags of tables of different sizes, one table at a time
    (`kernel.RaggedLayout`'s layout), with the ragged kernel's semantics:
    rows widened to float32, then summed in lookup order.

    tables:      [sum R, D] float
    indices:     [B, C] int: table t's ids at columns
                 [col_offsets[t], col_offsets[t + 1]), each in [0, R_t)
    row_offsets, col_offsets: sequences of T + 1 ints
    returns:     [B, T, D] float32
    """
    pooled = []
    for t in range(len(row_offsets) - 1):
        ids = indices[:, col_offsets[t]:col_offsets[t + 1]].long()
        pooled.append(tables[ids + row_offsets[t]].float().sum(dim=1))
    return torch.stack(pooled, dim=1)


def embedding_lookup_ref(table: torch.Tensor,
                         token_ids: torch.Tensor) -> torch.Tensor:
    """Plain gather (pooling=1 degenerate bag) — LM vocab embedding."""
    return table[token_ids.long()]


def summation_bound(table: torch.Tensor, indices: torch.Tensor,
                    weights: torch.Tensor | None = None,
                    mode: str = "sum") -> torch.Tensor:
    """Per-element tolerance [B, D] for a pooled f32 result against
    `embedding_bag_ref`: `2·eps_f32·Σ|w·x|`.

    Two f32 sums of the same L terms in different orders differ by far
    less than this. For `mean` the rule is carried through the division
    (÷ the denominator) plus one rounding of the quotient (`eps·|ref|`);
    a weighted mean's denominator Σw is itself a sum held to the same rule
    (`2·eps·|ref|` more).
    """
    rows = table[indices.long()].float().abs()           # [B, L, D]
    if weights is not None:
        rows = rows * weights.float().abs()[..., None]
    bound = 2 * F32_EPS * rows.sum(dim=1)
    if mode == "mean":
        ref = embedding_bag_ref(table.float(), indices, weights, mode)
        if weights is not None:
            denom = weights.float().sum(dim=1).clamp_min(1e-9)[..., None]
            quotient_eps = 3 * F32_EPS
        else:
            denom = float(indices.shape[1])
            quotient_eps = F32_EPS
        bound = bound / denom + quotient_eps * ref.abs()
    return bound
