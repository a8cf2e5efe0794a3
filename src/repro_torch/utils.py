"""Small helpers shared by the port: devices and dtypes, logging, timing,
JSON files."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:  # pragma: no cover - import-time wiring
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("REPRO_LOGLEVEL", "INFO"))


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
    is contiguous); a 2-byte void array is read as bfloat16 bits. A 0-d
    array stays 0-d (`np.ascontiguousarray` alone returns it as 1-d)."""
    arr = np.asarray(arr)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype_name(dtype) == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# -- timing ----------------------------------------------------------------------
@contextlib.contextmanager
def timed(label: str, sink: dict | None = None) -> Iterator[None]:
    """Host seconds of the block into `sink[label]` (and the debug log).
    The host clock sees only what the block waits for: synchronise the
    card inside the block to time its work."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = dt
    logger.debug("%s took %.3fs", label, dt)


def timeit_median(fn: Callable[[], Any], iters: int = 5,
                  warmup: int = 2) -> float:
    """Median seconds of `fn()`. Where the card is in use (CUDA
    initialised), every call is bracketed by `torch.cuda.synchronize()`,
    so a call's time covers its device work and none of the work queued
    before it."""
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def _run() -> float:
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        return time.perf_counter() - t0

    for _ in range(warmup):
        _run()
    return float(np.median([_run() for _ in range(iters)]))


# -- JSON files ------------------------------------------------------------------
def write_json(path: str, obj: Any) -> None:
    """Write `obj` as indented JSON, atomically (tmp file + `os.replace`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=_json_default)
    os.replace(tmp, path)  # atomic


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def _json_default(o: Any) -> Any:
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if torch.is_tensor(o):
        return o.detach().cpu().tolist()
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    return str(o)


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}PiB"
