"""Public wrappers around the embedding-bag kernel.

Backend selection:
  * 'cuda'  — the hand-written CUDA kernel; raises on a CPU tensor.
  * 'plain' — the eager PyTorch version in `ref` (the reference).
  * 'auto'  — the kernel for a CUDA tensor, the plain version for a CPU
              tensor. Nothing falls back: a CUDA tensor launches or raises.
"""
from __future__ import annotations

import dataclasses

import torch

from . import ref
from .kernel import EmbeddingBagOpts, embedding_bag_cuda

BACKENDS = ("auto", "cuda", "plain")


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """'auto' | 'cuda' | 'plain' -> 'cuda' | 'plain' for `tensor`'s device."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if tensor.is_cuda else "plain"
    if backend == "cuda" and not tensor.is_cuda:
        raise ValueError("backend='cuda' needs tensors on a CUDA device, got "
                         f"{tensor.device}")
    return backend


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None, *, mode: str = "sum",
                  backend: str = "auto",
                  opts: EmbeddingBagOpts | None = None) -> torch.Tensor:
    """Fixed-pooling embedding bag: [R,D] x [B,L] -> [B,D].

    When `opts.num_hot > 0` the caller is responsible for hot-first table
    order + remapped indices (core.embedding.EmbeddingBagCollection does this).
    The batch needs no padding to a multiple of `opts.batch_block` (the
    TPU path's `_pad_batch`): the CUDA grid masks the ragged edge itself.
    """
    if resolve_backend(backend, table) == "plain":
        return ref.embedding_bag_ref(table, indices, weights, mode=mode)
    opts = dataclasses.replace(opts or EmbeddingBagOpts(), mode=mode)
    idx = indices.to(torch.int32).contiguous()[:, None]           # [B, 1, L]
    w = None if weights is None else \
        weights.to(torch.float32).contiguous()[:, None]
    return embedding_bag_cuda(table[None], idx, w, opts)[:, 0]


def embedding_lookup(table: torch.Tensor, token_ids: torch.Tensor, *,
                     backend: str = "auto",
                     opts: EmbeddingBagOpts | None = None) -> torch.Tensor:
    """Plain gather (LM vocab embedding) as a pooling=1 bag.

    token_ids: any int shape [...]; returns [..., D].
    """
    if resolve_backend(backend, table) == "plain":
        return ref.embedding_lookup_ref(table, token_ids)
    flat = token_ids.reshape(-1, 1)
    out = embedding_bag(table, flat, mode="sum", backend="cuda", opts=opts)
    return out.reshape(*token_ids.shape, table.shape[1])
