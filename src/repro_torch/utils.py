"""Small helpers shared by the port."""
from __future__ import annotations

import numpy as np
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


# -- host form of a dtype ------------------------------------------------------
# numpy has no bfloat16. On the host the port carries a bfloat16 array as
# its 16-bit patterns (np.int16: `tensor.view(torch.int16)`), and on disk
# as numpy's 2-byte void (`|V2`), the descr `np.save` writes for the JAX
# package's `ml_dtypes` bfloat16 arrays, so each package reads the other's
# files. Every other dtype is its own host form.
BF16 = "bfloat16"


def dtype_name(dtype) -> str:
    """The name of a torch dtype, a numpy dtype (`ml_dtypes`' bfloat16 and
    a 2-byte void count as bfloat16) or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    dtype = np.dtype(dtype)
    if dtype.name == BF16 or (dtype.kind == "V" and dtype.itemsize == 2):
        return BF16
    return dtype.name


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype that holds `dtype`'s values on the host."""
    name = dtype_name(dtype)
    return np.dtype(np.int16) if name == BF16 else np.dtype(name)


def host_array(x) -> tuple[np.ndarray, str]:
    """(`x` on the host in its host form, `x`'s dtype name) for a tensor on
    any device or an array-like."""
    if torch.is_tensor(x):
        x = x.detach()
        name = dtype_name(x.dtype)
        if name == BF16:
            x = x.view(torch.int16)
        return x.cpu().numpy(), name
    x = np.asarray(x)
    name = dtype_name(x.dtype)
    return (x.view(np.int16) if name == BF16 else x), name


def to_tensor(arr: np.ndarray, dtype) -> torch.Tensor:
    """A CPU tensor of `dtype` over a host-form array (no copy when `arr`
    is contiguous); a 2-byte void array is read as bfloat16 bits."""
    arr = np.ascontiguousarray(arr)
    if dtype_name(dtype) == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
