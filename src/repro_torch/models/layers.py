"""Primitive layers used by the DLRM: init helper and the MLP tower.

Weights keep the TPU path's [in, out] layout and compute `x @ w + b`, so a
parameter tree from `repro.models.layers.mlp_tower_init` loads as it is
(`repro_torch.convert`). The norms, FFN and RoPE come with the LM zoo.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def dense_init(shape, dtype: torch.dtype, *, generator: torch.Generator,
               device, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (±2 standard deviations)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


class MLPTower(nn.Module):
    """Plain MLP tower (DLRM bottom/top): parameters w{i} [in, out], b{i}."""

    def __init__(self, dims: tuple[int, ...], dtype: torch.dtype, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.num_layers = len(dims) - 1
        for i in range(self.num_layers):
            self.register_parameter(f"w{i}", nn.Parameter(dense_init(
                (dims[i], dims[i + 1]), dtype, generator=generator,
                device=device)))
        for i in range(self.num_layers):
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(
                dims[i + 1], dtype=dtype, device=device)))

    def forward(self, x: torch.Tensor, *, final_act: bool = False):
        for i in range(self.num_layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.num_layers - 1 or final_act:
                x = torch.relu(x)
        return x
