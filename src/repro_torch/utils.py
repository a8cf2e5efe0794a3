"""Small helpers shared by the port."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`. Asking for CUDA where no card is
    visible raises: the port never moves a GPU request to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions")
    return device


def torch_dtype(name: str) -> torch.dtype:
    """'float32' / 'bfloat16' / ... -> the torch dtype of that name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
