"""MLPerf's DLRM-DCNv2 forward in plain PyTorch, the yardstick of the
port's CPU tests (`tests/test_torch_dlrm_dcnv2.py`).

Bottom MLP over the dense features (ReLU after every layer); one sum-pooled
bag a table, from tables of different sizes with a bag length of their
own; x0 = [bottom output, the T pooled bags], (T + 1)·D wide; a low-rank
cross network (DCN V2, arXiv:2008.13535, TorchRec's `LowRankCrossNet`),

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l,

and the top MLP (ReLU after every layer but the last) to one logit a
sample. Weights are [in, out] and a layer is `x @ w + b`; a cross layer's
parameters are (v [dim, rank], w [rank, dim], b [dim]).

Float32 throughout, with TF32 off, no kernel and no batching; it imports
nothing of `repro` or `repro_torch`. `lower=True` is the control, a step
below what the configuration states: bf16 tables are rounded to bf16
already, so the control rounds the pooled bags to bf16 and runs the
products in TF32.
"""
from __future__ import annotations

import contextlib

import torch


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
    """tables [sum R, D] (table t's rows after the rows of the tables
    before it), indices [B, sum L] (table t's ids after the ids of the
    tables before it) -> pooled bags [B, T, D] float32."""
    bags, row0, col0 = [], 0, 0
    for rows, pool in zip(table_rows, table_pooling):
        ids = indices[:, col0:col0 + pool].long()
        bag = tables[row0:row0 + rows][ids].float().sum(dim=1)
        bags.append(bag.to(torch.bfloat16).float() if lower else bag)
        row0, col0 = row0 + rows, col0 + pool
    return torch.stack(bags, dim=1)


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
           bags: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """dense [B, F], pooled bags [B, T, D] -> logits [B] float32."""
    with matmul_precision(lower):
        x = mlp(dense.float(), bottom_layers, relu_last=True)
        x0 = torch.cat([x, bags.reshape(bags.shape[0], -1)], dim=1)
        return mlp(cross(x0, cross_layers), top_layers,
                   relu_last=False)[:, 0]
