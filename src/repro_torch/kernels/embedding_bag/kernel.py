"""CUDA embedding-bag kernel: checks and launch.

`csrc/embedding_bag.cu` replaces the Pallas TPU kernel
`repro/kernels/embedding_bag/kernel.py::_bag_kernel`. It is built, bound
and launched through `kernels/library.py`, the port's one CUDA library; a
failed build raises: there is no fallback to the plain version.

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

Tables of different sizes, each with its own bag length (`RaggedLayout`),
go to a second kernel on the same core, `csrc/ragged_bag.cu`: one launch
pools every table of a flat [sum R, D] buffer into float32 bags
(`embedding_bag_ragged_cuda`). It takes sum pooling of unweighted bags
only, with no hot operand and no backward.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading

import torch

from repro_torch.kernels import library
from repro_torch.tracing import span

#: Launches of the CUDA bag kernels since the count was last set to 0.
#: Only `embedding_bag_cuda` and `embedding_bag_ragged_cuda` add to it,
#: once per launch, through `_count_launch`: the sharded backend's shard
#: threads launch at once, and `+=` on a module global is a
#: read-modify-write that could lose a count.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

MAX_BATCH_BLOCK = 8        # kMaxBagsPerBlock in bag_common.cuh
RING_DEPTHS = (2, 16)      # kMinRingDepth, kMaxRingDepth in bag_common.cuh
ROW_PASS_BYTES = 512       # kRowPass: a row's bytes one warp pass covers
ENTRY_BYTES = 64 * 8       # kEntries staged row addresses a warp
WEIGHT_BYTES = 64 * 4      # kEntries staged weights a warp (weighted bags)


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
        kernels report they launched with (`last_launch_info`)."""
        vec = dim * itemsize % 16 == 0
        per_warp = ((self.ring_depth() * ROW_PASS_BYTES if vec else 0)
                    + ENTRY_BYTES + (WEIGHT_BYTES if weighted else 0))
        return self.batch_block * per_warp


@dataclasses.dataclass(frozen=True)
class EmbeddingBagOpts(LaunchGeometry):
    """Tuning knobs (paper-mechanism analogues)."""

    num_hot: int = 0             # rows read through the hot operand; 0 = off
    mode: str = "sum"            # 'sum' | 'mean'


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


LAUNCH_INFO_KEYS = ("registers", "blocks_per_sm", "local_bytes",
                    "static_shared_bytes", "ring_depth", "bags_per_block",
                    "dynamic_shared_bytes")   # bag_common::launch_info


def last_launch_info() -> dict:
    """Registers per thread, resident blocks per SM, spill bytes and
    geometry of the embedding-bag instantiation launched last."""
    return library.launch_info("embedding_bag_last_launch_info",
                               LAUNCH_INFO_KEYS)


def ragged_last_launch_info() -> dict:
    """`last_launch_info` of the ragged-tables kernel."""
    return library.launch_info("ragged_bag_last_launch_info",
                               LAUNCH_INFO_KEYS)


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
    with span("embedding_bag.launch"):
        opts.validate()
        if opts.mode not in ("sum", "mean"):
            raise ValueError(f"unknown mode {opts.mode!r}")
        if not tables.is_cuda:
            raise ValueError("embedding_bag_cuda needs tables on a CUDA "
                             "device; CPU tensors go to "
                             "ref.embedding_bag_ref")
        if tables.dim() != 3 or tables.dtype not in library.DTYPE_CODES \
                or tables.stride(2) != 1:
            raise ValueError(f"tables must be [T, R, D] float32/bfloat16 with "
                             f"contiguous rows, got {tuple(tables.shape)} "
                             f"{tables.dtype} strides {tables.stride()}")
        if (indices.dim() != 3 or indices.dtype != torch.int32
                or not indices.is_contiguous()
                or indices.device != tables.device
                or indices.shape[1] > tables.shape[0]):
            raise ValueError(f"indices must be contiguous int32 "
                             f"[B, T<={tables.shape[0]}, L] "
                             f"on {tables.device}, got {tuple(indices.shape)} "
                             f"{indices.dtype} on {indices.device}")
        if weights is not None and (
                weights.shape != indices.shape
                or weights.dtype != torch.float32
                or not weights.is_contiguous()
                or weights.device != tables.device):
            raise ValueError(f"weights must be contiguous float32 "
                             f"{tuple(indices.shape)} on {tables.device}")
        batch, num_tables, pooling = indices.shape
        rows, dim = tables.shape[1], tables.shape[2]
        num_hot = max(0, min(opts.num_hot, rows))
        # the hot operand is a view of each table's hot-first prefix, never
        # a copy, so an in-place online update can never leave it stale
        hot = tables[:, :num_hot]
        out = torch.empty((batch, num_tables, dim), dtype=tables.dtype,
                          device=tables.device)
        if out.numel() == 0:
            return out
        library.launch(
            "embedding_bag_launch", tables.device,
            tables.data_ptr(), tables.stride(0), tables.stride(1),
            hot.data_ptr(), hot.stride(0), hot.stride(1), num_hot, rows,
            indices.data_ptr(),
            None if weights is None else weights.data_ptr(),
            out.data_ptr(), batch, num_tables, pooling, dim,
            library.DTYPE_CODES[tables.dtype], int(opts.mode == "mean"),
            opts.batch_block, opts.prefetch_distance)
        _count_launch()
        return out


@dataclasses.dataclass(frozen=True)
class RaggedLayout:
    """Tables of different sizes, each with its own bag length.

    The tables are one flat buffer [sum(rows), D]: table t's rows are
    [row_offsets[t], row_offsets[t + 1]). A sample's ids are one row of
    indices [B, sum(pooling)]: table t's at columns [col_offsets[t],
    col_offsets[t + 1]), each in [0, rows[t])."""

    rows: tuple[int, ...]
    pooling: tuple[int, ...]

    def __post_init__(self):
        if not self.rows or len(self.rows) != len(self.pooling):
            raise ValueError(f"{len(self.rows)} table sizes and "
                             f"{len(self.pooling)} bag sizes: give one of "
                             f"each for every table")
        if min(self.rows) < 1 or min(self.pooling) < 1:
            raise ValueError(f"table sizes {self.rows} and bag sizes "
                             f"{self.pooling} must be positive")
        if max(self.rows) > 2**31 - 1:
            raise ValueError("a table's ids are int32: at most 2**31 - 1 "
                             "rows a table")

    @property
    def num_tables(self) -> int:
        return len(self.rows)

    @property
    def cols(self) -> int:
        """Ids a sample: the indices' second dimension."""
        return sum(self.pooling)

    def row_offsets(self) -> list[int]:
        return [0, *itertools.accumulate(self.rows)]

    def col_offsets(self) -> list[int]:
        return [0, *itertools.accumulate(self.pooling)]

    def table_order(self) -> list[int]:
        """The tables by bag length, longest first (ties in table order):
        the order in which the kernel's grid rows pool them."""
        return sorted(range(self.num_tables), key=lambda t: -self.pooling[t])


def embedding_bag_ragged_cuda(tables: torch.Tensor, indices: torch.Tensor,
                              row_offsets: torch.Tensor,
                              col_offsets: torch.Tensor,
                              table_order: torch.Tensor,
                              opts: LaunchGeometry = LaunchGeometry()
                              ) -> torch.Tensor:
    """Sum-pooled bags of tables of different sizes in one launch of the
    CUDA kernel `csrc/ragged_bag.cu` (layout: `RaggedLayout`).

    tables:      [sum R, D] float32 or bfloat16 on a CUDA device, rows
                 contiguous
    indices:     [B, C] int32, contiguous: table t's ids at columns
                 [col_offsets[t], col_offsets[t + 1]), each in [0, R_t)
    row_offsets: [T + 1] int64, col_offsets [T + 1] int32, table_order [T]
                 int32, on the tables' device (`RaggedLayout`'s lists)
    returns:     [B, T, D] float32
    """
    with span("embedding_bag.ragged_launch"):
        opts.validate()
        if not tables.is_cuda:
            raise ValueError("embedding_bag_ragged_cuda needs tables on a "
                             "CUDA device; CPU tensors go to "
                             "ref.ragged_tables_bag_ref")
        if tables.dim() != 2 or tables.dtype not in library.DTYPE_CODES \
                or tables.stride(1) != 1:
            raise ValueError(f"tables must be [N, D] float32/bfloat16 with "
                             f"contiguous rows, got {tuple(tables.shape)} "
                             f"{tables.dtype} strides {tables.stride()}")
        num_tables = table_order.shape[0]
        for name, t, dtype, n in (("row_offsets", row_offsets, torch.int64,
                                   num_tables + 1),
                                  ("col_offsets", col_offsets, torch.int32,
                                   num_tables + 1),
                                  ("table_order", table_order, torch.int32,
                                   num_tables)):
            if (t.shape != (n,) or t.dtype != dtype
                    or not t.is_contiguous() or t.device != tables.device):
                raise ValueError(f"{name} must be contiguous {dtype} [{n}] "
                                 f"on {tables.device}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if (indices.dim() != 2 or indices.dtype != torch.int32
                or not indices.is_contiguous()
                or indices.device != tables.device):
            raise ValueError(f"indices must be contiguous int32 [B, C] on "
                             f"{tables.device}, got {tuple(indices.shape)} "
                             f"{indices.dtype} on {indices.device}")
        batch, cols = indices.shape
        dim = tables.shape[1]
        out = torch.empty((batch, num_tables, dim), dtype=torch.float32,
                          device=tables.device)
        if out.numel() == 0:
            return out
        library.launch(
            "ragged_bag_launch", tables.device,
            tables.data_ptr(), tables.stride(0), row_offsets.data_ptr(),
            col_offsets.data_ptr(), table_order.data_ptr(),
            indices.data_ptr(), out.data_ptr(), batch, num_tables, cols,
            dim, library.DTYPE_CODES[tables.dtype], opts.batch_block,
            opts.prefetch_distance)
        _count_launch()
        return out
