"""A gradient for the embedding-bag kernel.

`EmbeddingBagFunction` is a `torch.autograd.Function` whose forward is
`kernel.embedding_bag_cuda`, the same launch (counted in
`kernel.LAUNCHES`) and the same bits as a lookup that asks for no
gradient. Its backward is `embedding_bag_backward`, plain PyTorch: the
TPU path has no backward kernel either, its table gradient is XLA's
transpose of the gather in `_pool_rows_core`, computed outside any Pallas
kernel. A backward kernel fused with row-wise Adagrad is a candidate in
ROADMAP.md Queue 2, with the times of this one (PERF.md).

The gradient is dense, `[T', R, D]` like the tables, as the reference's
is: row `idx[b, t, l]` of table `t` gets `w[b, t, l] · grad_out[b, t]`,
divided by L for a mean, or by `max(Σ_l w, 1e-9)` for a weighted mean.
The per-lookup weights get no gradient: they are data.
"""
from __future__ import annotations

import torch

from .kernel import EmbeddingBagOpts, embedding_bag_cuda


def check_indices(indices: torch.Tensor, num_rows: int) -> None:
    """Raise IndexError unless every index lies in [0, num_rows).

    The forward kernel turns an out-of-range index into a NaN bag; the
    backward must never scatter one: a device-side assert inside the
    scatter would leave the CUDA context unusable."""
    if indices.numel() == 0:
        return
    lo, hi = torch.aminmax(indices)
    lo, hi = int(lo), int(hi)
    if lo < 0 or hi >= num_rows:
        raise IndexError(f"embedding-bag backward: indices span [{lo}, {hi}],"
                         f" outside [0, {num_rows}) rows")


def embedding_bag_backward(grad_out: torch.Tensor, indices: torch.Tensor,
                           weights: torch.Tensor | None, mode: str,
                           table_shape) -> torch.Tensor:
    """The table gradient of `embedding_bag_cuda` (and of
    `ref.embedding_bag_ref` table by table).

    grad_out: [B, T, D], the gradient of the pooled output
    indices:  [B, T, L] int, in [0, R) (IndexError otherwise, before any
              write)
    weights:  [B, T, L] or None
    table_shape: (T', R, D) with T' >= T; tables past T get zeros

    Returns the `[T', R, D]` gradient in float32, or in `grad_out`'s
    dtype where that is wider (bfloat16 gradients accumulate in float32).

    The scatter is `index_put_(accumulate=True)` over `[T'·R, D]`, which
    on CUDA sorts the flat row ids (a stable radix sort) and sums each
    row's contributions in that order: the same bits on every run.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown mode {mode!r}")
    num_tables, num_rows, dim = (int(s) for s in table_shape)
    batch, tables, pooling = indices.shape
    if tables > num_tables or grad_out.shape != (batch, tables, dim):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} and indices "
                         f"{tuple(indices.shape)} do not fit tables "
                         f"{tuple(table_shape)}")
    check_indices(indices, num_rows)
    g = grad_out.to(torch.promote_types(grad_out.dtype, torch.float32))
    out = torch.zeros(tuple(table_shape), dtype=g.dtype, device=g.device)
    if mode == "mean":
        if weights is not None:
            g = g / weights.to(g.dtype).sum(dim=2).clamp_min(1e-9)[..., None]
        else:
            g = g / pooling
    vals = g[:, :, None, :].expand(batch, tables, pooling, dim)
    if weights is not None:
        vals = vals * weights[..., None].to(g.dtype)
    offset = torch.arange(tables, device=indices.device)[None, :, None]
    flat = (indices.long() + offset * num_rows).reshape(-1)
    out.view(num_tables * num_rows, dim).index_put_(
        (flat,), vals.reshape(-1, dim).to(out.dtype), accumulate=True)
    return out


class EmbeddingBagFunction(torch.autograd.Function):
    """`embedding_bag_cuda` with a table gradient (see the module
    docstring): `EmbeddingBagFunction.apply(tables, indices, weights,
    opts)`, the arguments of `embedding_bag_cuda`."""

    @staticmethod
    def forward(ctx, tables, indices, weights, opts):
        out = embedding_bag_cuda(tables, indices, weights, opts)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(indices, weights)
            ctx.mode = opts.mode
            ctx.table_shape = tuple(tables.shape)
            ctx.table_dtype = tables.dtype
        return out

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        indices, weights = ctx.saved_tensors
        grad = embedding_bag_backward(grad_out.contiguous(), indices, weights,
                                      ctx.mode, ctx.table_shape)
        return grad.to(ctx.table_dtype), None, None, None

