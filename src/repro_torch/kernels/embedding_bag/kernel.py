"""CUDA embedding-bag kernel: build, bind and launch.

`csrc/embedding_bag.cu` replaces the Pallas TPU kernel
`repro/kernels/embedding_bag/kernel.py::_bag_kernel`. It is compiled with
`nvcc` for `sm_90a` into a shared library with a plain C interface, at
first use, from the sources in the checkout only, into
`build/repro_torch_kernels/` keyed by a hash of the sources and flags, and
loaded with `ctypes`. A missing `nvcc` or a failed build raises: there is
no fallback to the plain version. `BUILD_DIR` lies in the checkout that
holds `src/`, so the port runs from a checkout, not from an installed copy.

The paper's mechanisms on Hopper:

* software prefetching (paper §IV-B) -> a register ring per warp that keeps
  `prefetch_distance` row loads of the bag in flight;
* L2 pinning (paper §IV-C) -> rows `< num_hot` (tables stored hot-first,
  see core/hot_cache.py) are read through a separate `hot` operand, the
  hot-first prefix of each table; pinning it with a persisting L2 window
  is later work;
* occupancy (paper §III-C) -> `batch_block` bags (one warp each) per
  thread block.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

#: Launches of the CUDA kernel since the count was last set to 0. Only
#: `embedding_bag_cuda` adds to it, once per launch.
LAUNCHES = 0

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "embedding_bag.cu",)
HEADERS = (CSRC / "bag_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_BATCH_BLOCK = 8        # kMaxBagsPerBlock in the source
MAX_PREFETCH = 16          # kMaxDistance in the source
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


@dataclasses.dataclass(frozen=True)
class EmbeddingBagOpts:
    """Tuning knobs (paper-mechanism analogues)."""

    prefetch_distance: int = 8   # row loads in flight per warp; the kernel
    #                              takes the largest power of two <= it, <= 16
    batch_block: int = 8         # bags (warps) per thread block, <= 8
    num_hot: int = 0             # rows read through the hot operand; 0 = off
    mode: str = "sum"            # 'sum' | 'mean'

    def register_bytes(self, dim: int, itemsize: int = 4) -> int:
        """Register-file bytes one thread block holds in its prefetch rings
        and accumulators (the kernel uses no shared memory). A warp covers
        512 bytes of a row per pass (16 bytes a lane)."""
        distance = 1
        while (distance * 2 <= min(self.prefetch_distance, MAX_PREFETCH)):
            distance *= 2
        row_pass = min(dim * itemsize, 32 * 16)
        acc = row_pass // itemsize * 4           # f32 accumulators
        return self.batch_block * (distance * row_pass + acc)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are built from source and have no fallback")


def build_library(stem: str, sources, headers=()) -> dict:
    """Compile `sources` into `lib{stem}_{hash}.so` unless this exact
    source (headers and flags included) is built.

    Returns {'path', 'seconds', 'cached', 'log'}; `log` holds nvcc's output
    (ptxas register and spill counts)."""
    nvcc = _nvcc()
    digest = hashlib.sha256()
    for src in (*sources, *headers):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "cached": True, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds, "cached": False,
            "log": proc.stdout + proc.stderr}


def build() -> dict:
    """Compile the embedding-bag kernel library (see `build_library`)."""
    return build_library("embedding_bag", SOURCES, HEADERS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        ll, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lib.embedding_bag_launch.argtypes = [
            ptr, ll, ll, ptr, ll, ll, ll, ll, ptr, ptr, ptr, ll,
            i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.embedding_bag_launch.restype = i32
        lib.embedding_bag_error_string.argtypes = [i32]
        lib.embedding_bag_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def embedding_bag_cuda(tables: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor | None = None,
                       opts: EmbeddingBagOpts = EmbeddingBagOpts()
                       ) -> torch.Tensor:
    """Pooled embedding bags of every table in one launch of the CUDA kernel.

    tables:  [T', R, D] float32 or bfloat16 on a CUDA device, rows
             contiguous (any table stride; T' >= T). With `opts.num_hot > 0`
             the tables are stored hot-first and `indices` remapped (see
             core/hot_cache.HotPlan).
    indices: [B, T, L] int32, contiguous, in [0, R)
    weights: [B, T, L] float32, contiguous, or None
    returns: [B, T, D] in the tables' dtype
    """
    global LAUNCHES
    if not tables.is_cuda:
        raise ValueError("embedding_bag_cuda needs tables on a CUDA device; "
                         "CPU tensors go to ref.embedding_bag_ref")
    if tables.dim() != 3 or tables.dtype not in _DTYPE_CODES \
            or tables.stride(2) != 1:
        raise ValueError(f"tables must be [T, R, D] float32/bfloat16 with "
                         f"contiguous rows, got {tuple(tables.shape)} "
                         f"{tables.dtype} strides {tables.stride()}")
    if (indices.dim() != 3 or indices.dtype != torch.int32
            or not indices.is_contiguous()
            or indices.device != tables.device
            or indices.shape[1] > tables.shape[0]):
        raise ValueError(f"indices must be contiguous int32 [B, T<={tables.shape[0]}, L] "
                         f"on {tables.device}, got {tuple(indices.shape)} "
                         f"{indices.dtype} on {indices.device}")
    if weights is not None and (
            weights.shape != indices.shape or weights.dtype != torch.float32
            or not weights.is_contiguous() or weights.device != tables.device):
        raise ValueError(f"weights must be contiguous float32 "
                         f"{tuple(indices.shape)} on {tables.device}")
    if opts.mode not in ("sum", "mean"):
        raise ValueError(f"unknown mode {opts.mode!r}")
    if not 1 <= opts.batch_block <= MAX_BATCH_BLOCK:
        raise ValueError(f"batch_block must be in [1, {MAX_BATCH_BLOCK}]")
    batch, num_tables, pooling = indices.shape
    rows, dim = tables.shape[1], tables.shape[2]
    num_hot = max(0, min(opts.num_hot, rows))
    # the hot operand is a view of each table's hot-first prefix, never a
    # copy, so an in-place online update can never leave it stale
    hot = tables[:, :num_hot]
    out = torch.empty((batch, num_tables, dim), dtype=tables.dtype,
                      device=tables.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.embedding_bag_launch(
            tables.data_ptr(), tables.stride(0), tables.stride(1),
            hot.data_ptr(), hot.stride(0), hot.stride(1), num_hot, rows,
            indices.data_ptr(),
            None if weights is None else weights.data_ptr(),
            out.data_ptr(), batch, num_tables, pooling, dim,
            _DTYPE_CODES[tables.dtype], int(opts.mode == "mean"),
            opts.batch_block, opts.prefetch_distance, stream)
    if err:
        raise RuntimeError("embedding_bag kernel launch failed: "
                           + lib.embedding_bag_error_string(err).decode())
    LAUNCHES += 1
    return out
