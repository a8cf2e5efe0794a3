"""CUDA embedding-bag kernel: build, bind and launch.

`csrc/embedding_bag.cu` replaces the Pallas TPU kernel
`repro/kernels/embedding_bag/kernel.py::_bag_kernel`. It is compiled with
`nvcc` for `sm_90a` into a shared library with a plain C interface, at
first use, from the sources in the checkout only, into
`build/repro_torch_kernels/` keyed by a hash of the sources and flags, and
loaded with `ctypes`. A missing `nvcc` or a failed build raises: there is
no fallback to the plain version. `BUILD_DIR` lies in the checkout that
holds `src/`, so the port runs from a checkout, not from an installed copy.

The paper's mechanisms on Hopper (the design is in `csrc/bag_common.cuh`,
shared with the fused kernel):

* software prefetching (paper §IV-B) -> a ring of `prefetch_distance` row
  slots per warp in shared memory, filled by asynchronous copies
  (`cp.async`) depth-1 lookups ahead of the pooling loop;
* L2 pinning (paper §IV-C) -> rows `< num_hot` (tables stored hot-first,
  see core/hot_cache.py) are read through a separate `hot` operand, the
  hot-first prefix of each table; pinning it with a persisting L2 window
  is later work;
* occupancy (paper §III-C) -> `batch_block` bags (one warp each) per
  thread block; with the ring in shared memory, registers no longer cap
  the resident warps. `last_launch_info` reports the registers per thread
  and the resident blocks per SM of the instantiation launched, as the
  CUDA runtime counts them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

#: Launches of the CUDA kernel since the count was last set to 0. Only
#: `embedding_bag_cuda` adds to it, once per launch, through
#: `_count_launch`: the sharded backend's shard threads launch at once, and
#: `+=` on a module global is a read-modify-write that could lose a count.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
# the first launch builds and loads the library: one thread does it
_LOAD_LOCK = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "embedding_bag.cu",)
HEADERS = (CSRC / "bag_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_BATCH_BLOCK = 8        # kMaxBagsPerBlock in bag_common.cuh
RING_DEPTHS = (2, 16)      # kMinRingDepth, kMaxRingDepth in bag_common.cuh
ROW_PASS_BYTES = 512       # kRowPass: a row's bytes one warp pass covers
ENTRY_BYTES = 64 * 8       # kEntries staged row addresses a warp
WEIGHT_BYTES = 64 * 4      # kEntries staged weights a warp (weighted bags)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """The launch shape both lookup kernels share (bag_common.cuh)."""

    prefetch_distance: int = 4   # ring depth asked for: row slots per warp
    #                              in shared memory, depth-1 copies in flight
    batch_block: int = 8         # bags (warps) per thread block, <= 8

    def validate(self) -> None:
        """Raise ValueError on options beyond the kernels' limits; the
        wrappers call it before anything is launched."""
        if not 1 <= self.batch_block <= MAX_BATCH_BLOCK:
            raise ValueError(f"batch_block must be in [1, {MAX_BATCH_BLOCK}]"
                             f", got {self.batch_block}")
        if self.prefetch_distance < 1:
            raise ValueError(f"prefetch_distance must be >= 1, got "
                             f"{self.prefetch_distance}")

    def ring_depth(self) -> int:
        """The depth the kernels take (bag_common::ring_depth): the largest
        power of two <= prefetch_distance, clamped to RING_DEPTHS."""
        lo, hi = RING_DEPTHS
        depth = lo
        while depth * 2 <= min(self.prefetch_distance, hi):
            depth *= 2
        return depth

    def shared_bytes(self, dim: int, itemsize: int = 4,
                     weighted: bool = False) -> int:
        """Dynamic shared memory of one thread block: per warp (one warp
        pools a bag), the row ring (ring_depth x 512 bytes, where a row's
        bytes are a multiple of 16; the scalar path has no ring), the 64
        staged row addresses and, for weighted bags, the 64 staged
        weights. A row wider than 512 bytes is pooled in several passes
        over the same ring. chip_smoke.py holds this to the bytes the
        libraries report they launched with (`last_launch_info`)."""
        vec = dim * itemsize % 16 == 0
        per_warp = ((self.ring_depth() * ROW_PASS_BYTES if vec else 0)
                    + ENTRY_BYTES + (WEIGHT_BYTES if weighted else 0))
        return self.batch_block * per_warp


@dataclasses.dataclass(frozen=True)
class EmbeddingBagOpts(LaunchGeometry):
    """Tuning knobs (paper-mechanism analogues)."""

    num_hot: int = 0             # rows read through the hot operand; 0 = off
    mode: str = "sum"            # 'sum' | 'mean'


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


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def _library():
    global _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build()["path"])
        ll, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lib.embedding_bag_launch.argtypes = [
            ptr, ll, ll, ptr, ll, ll, ll, ll, ptr, ptr, ptr, ll,
            i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.embedding_bag_launch.restype = i32
        lib.embedding_bag_last_launch_info.argtypes = [ptr]
        lib.embedding_bag_last_launch_info.restype = i32
        lib.embedding_bag_error_string.argtypes = [i32]
        lib.embedding_bag_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


LAUNCH_INFO_KEYS = ("registers", "blocks_per_sm", "local_bytes",
                    "static_shared_bytes", "ring_depth", "bags_per_block",
                    "dynamic_shared_bytes")   # bag_common::launch_info


def launch_info(query, error_string) -> dict:
    """Ask a library about the instantiation it launched last
    (`bag_common::launch_info`: cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = (ctypes.c_int * len(LAUNCH_INFO_KEYS))()
    err = query(out)
    if err:
        raise RuntimeError("launch info query failed: "
                           + error_string(err).decode())
    return dict(zip(LAUNCH_INFO_KEYS, out))


def last_launch_info() -> dict:
    """Registers per thread, resident blocks per SM, spill bytes and
    geometry of the embedding-bag instantiation launched last."""
    lib = _library()
    return launch_info(lib.embedding_bag_last_launch_info,
                       lib.embedding_bag_error_string)


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
    opts.validate()
    if opts.mode not in ("sum", "mean"):
        raise ValueError(f"unknown mode {opts.mode!r}")
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
    _count_launch()
    return out
