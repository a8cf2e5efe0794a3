"""MLPerf's DLRM-DCNv2 forward (mlcommons/training
`recommendation_v2/torchrec_dlrm`; DCN V2, arXiv:2008.13535) in plain
PyTorch.

Bottom MLP over the dense features (ReLU after every layer); one
sum-pooled bag a table, from tables of different sizes held as one flat
buffer [sum R, D], each with a bag length of its own; x0 = [bottom output,
the T pooled bags], (T + 1)·D wide; the low-rank cross network, layer by
layer

    x_{l+1} = x0 * ((x_l @ v_l) @ w_l + b_l) + x_l

with v_l [dim, rank], w_l [rank, dim], b_l [dim]; and the top MLP (ReLU
after every layer but the last) to one logit a sample. Weights are [in,
out] and a layer is `x @ w + b`.

Float32 with TF32 off: rows are widened to float32 and summed. The
forward runs in blocks of samples, table by table, so that it fits on the
card beside the tables it reads. It imports nothing of the program under
test.

`lower=True` is the control, one precision step below what the
configuration states. The rows are bf16 already, so rounding them is no
step: the control rounds each pooled bag to bfloat16 and runs the matrix
products in TF32 (`allow_tf32`).
"""
from __future__ import annotations

import contextlib

import torch

BLOCK_BYTES = 1 << 30      # gathered f32 rows held at once
LOGIT_BLOCK = 2048         # samples a block of the dense part


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


def pooled(tables: torch.Tensor, table_rows, table_pooling,
           indices: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """tables [sum R, D] (table t's rows after those of the tables before
    it), indices [B, sum L] (table t's ids after those of the tables before
    it, each in [0, R_t)) -> pooled bags [B, T, D] float32."""
    batch, dim = indices.shape[0], tables.shape[1]
    out = torch.empty((batch, len(table_rows), dim), dtype=torch.float32,
                      device=tables.device)
    row0 = col0 = 0
    for t, (rows, pool) in enumerate(zip(table_rows, table_pooling)):
        table = tables[row0:row0 + rows]
        bb = max(1, min(batch, BLOCK_BYTES // (pool * dim * 4)))
        for b0 in range(0, batch, bb):
            ids = indices[b0:b0 + bb, col0:col0 + pool].long()
            bag = table[ids].float().sum(dim=1)
            if lower:
                bag = bag.to(torch.bfloat16).float()
            out[b0:b0 + bb, t] = bag
        row0, col0 = row0 + rows, col0 + pool
    return out


def mlp(x: torch.Tensor, layers, relu_last: bool) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1 or relu_last:
            x = torch.relu(x)
    return x


def cross(x0: torch.Tensor, layers) -> torch.Tensor:
    x = x0
    for v, w, b in layers:
        x = x0 * ((x @ v) @ w + b) + x
    return x


def logits(bottom_layers, cross_layers, top_layers, dense: torch.Tensor,
           bags: torch.Tensor, lower: bool = False,
           block: int = LOGIT_BLOCK) -> torch.Tensor:
    """dense [B, F], pooled bags [B, T, D] -> logits [B] float32."""
    out = []
    with matmul_precision(lower):
        for b0 in range(0, dense.shape[0], block):
            x = mlp(dense[b0:b0 + block], bottom_layers, relu_last=True)
            bag = bags[b0:b0 + block]
            x0 = torch.cat([x, bag.reshape(bag.shape[0], -1)], dim=1)
            out.append(mlp(cross(x0, cross_layers), top_layers,
                           relu_last=False)[:, 0])
    return torch.cat(out)
