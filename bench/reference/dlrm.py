"""The DLRM forward (Naumov et al., arXiv:1906.00091) in plain PyTorch.

Bottom MLP over the dense features (ReLU after every layer), one pooled
embedding bag a table (gather the rows, sum or mean), the dot interaction
(the bottom output and the T pooled vectors, every pair i < j of the T + 1
in row-major order, after the bottom output itself), and the top MLP (ReLU
after every layer but the last) to one logit a query.

Weights are [in, out] and a layer is `x @ w + b`. The forward runs in
blocks of queries and of tables, so that it fits on the card beside the
tables it reads. It imports nothing of the program under test.

`lower=True` is the control: the same forward one precision step below
what the configuration states. Rows are rounded to bfloat16 before they
are pooled (the step a table stored in bf16 would take), and the matrix
products run in TF32 (`allow_tf32`).
"""
from __future__ import annotations

import contextlib

import torch

BLOCK_BYTES = 1 << 30      # gathered rows held at once


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 in matrix products on or off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def pooled(tables: torch.Tensor, indices: torch.Tensor, combine: str = "sum",
           lower: bool = False) -> torch.Tensor:
    """tables [T', R, D], indices [B, T, L] -> pooled [B, T, D] float32."""
    batch, num_tables, pooling = indices.shape
    rows, dim = tables.shape[1], tables.shape[2]
    out = torch.empty((batch, num_tables, dim), dtype=torch.float32,
                      device=tables.device)
    per_bag = pooling * dim * 4
    tb = max(1, min(num_tables, BLOCK_BYTES // max(1, per_bag * batch)))
    bb = max(1, min(batch, BLOCK_BYTES // (per_bag * tb)))
    for t0 in range(0, num_tables, tb):
        t1 = min(num_tables, t0 + tb)
        flat = tables[t0:t1].reshape(-1, dim)
        offset = (torch.arange(t1 - t0, device=tables.device)
                  * rows)[None, :, None]
        for b0 in range(0, batch, bb):
            b1 = min(batch, b0 + bb)
            got = flat[indices[b0:b1, t0:t1].long() + offset]   # [b, t, L, D]
            if lower:
                got = got.to(torch.bfloat16)
            got = got.float()
            bag = got.sum(dim=2)
            if combine == "mean":
                bag = bag / pooling
            elif combine != "sum":
                raise ValueError(f"unknown combine {combine!r}")
            out[b0:b1, t0:t1] = bag
    return out


def mlp(x: torch.Tensor, layers, relu_last: bool) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1 or relu_last:
            x = torch.relu(x)
    return x


def interact(bottom: torch.Tensor, bags: torch.Tensor) -> torch.Tensor:
    """bottom [B, D], bags [B, T, D] -> [B, D + (T+1)T/2]."""
    feats = torch.cat([bottom[:, None, :], bags], dim=1)
    n = feats.shape[1]
    gram = torch.bmm(feats, feats.transpose(1, 2))
    i, j = torch.triu_indices(n, n, offset=1, device=feats.device)
    return torch.cat([bottom, gram[:, i, j]], dim=1)


def logits(bottom_layers, top_layers, dense: torch.Tensor,
           bags: torch.Tensor, lower: bool = False,
           block: int = 2048) -> torch.Tensor:
    """dense [B, F], pooled bags [B, T, D] -> logits [B] float32."""
    out = []
    with matmul_precision(lower):
        for b0 in range(0, dense.shape[0], block):
            x = mlp(dense[b0:b0 + block], bottom_layers, relu_last=True)
            z = interact(x, bags[b0:b0 + block])
            out.append(mlp(z, top_layers, relu_last=False)[:, 0])
    return torch.cat(out)
