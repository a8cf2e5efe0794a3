"""Fused warm-cache lookup: hit gather + pooled sum + miss list in one launch.

`csrc/fused_lookup.cu` replaces the Pallas TPU kernel
`repro/kernels/embedding_bag/fused.py::_fused_kernel`. It is built, bound
and launched through `kernels/library.py` at first use, with no fallback,
like the embedding-bag kernel.

Slot-map convention (as on the TPU path), per (bag, position):

    -1 (MISS)            zero contribution, emitted on the miss list
    <= -2 (PAD)          zero contribution, silent
    [0, K)               row of the hot block `hot`
    [K, K + C)           warm-cache slot + K

The kernel writes the RAW (weighted) per-bag sum; a mean is an eager
epilogue outside the launch (`mean_epilogue`), as on the TPU path. Bags
that held a miss are later recomputed whole by `complete_miss_bags`, never
completed by adding cold rows to the partial sum, so the tiered backend's
pooled output is bit for bit the device backend's: the fused kernel and the
embedding-bag kernel share their arithmetic (`csrc/bag_common.cuh`), and
`complete_miss_bags` pools through the embedding-bag kernel itself.

Entry points:
  * `fused_warm_lookup`: the single-table wrapper of the TPU path's
    signature, [C, D] x slot map [B, L] -> `FusedLookupResult`;
  * `fused_warm_lookup_tables`: what the parameter server calls, every table
    in ONE launch over [T, C, D] / [B, T, L];
  * `fused_warm_lookup_plain`: the plain PyTorch version (gather, select,
    multiply, `sum(dim=1)`), with `_miss_list_from_slots` for the lists.
A wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.kernels import library

from . import kernel
from .ops import resolve_backend

MISS = -1          # slot-map sentinel: miss — zero contribution + emission
PAD = -2           # slot-map sentinel: padded dummy bag — zero, no emission

#: The embedding-bag kernel's options for bag completion (`pool_bag_rows`):
#: one table of n·L rows, each read once.
COMPLETION_OPTS = kernel.EmbeddingBagOpts()

#: Launches of the gather-and-pool kernel since the count was last set to 0.
#: Only `pool_tables` adds to it, once per launch, through `_count_launch`
#: (under a lock: the sharded backend's shard threads launch at once).
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class FusedLookupOpts(kernel.LaunchGeometry):
    """Tuning knobs: the launch shape shared with the embedding-bag kernel
    (`kernel.LaunchGeometry`: ring depth, bags per block)."""


@dataclasses.dataclass(frozen=True)
class FusedLookupResult:
    """`pooled` stays on the cache's device; the miss list is host-side
    numpy (its consumer is the host cold path)."""

    pooled: torch.Tensor     # [B, D] cache dtype
    miss_rows: np.ndarray    # [n_distinct] int32, ascending
    miss_pos: np.ndarray     # [n_occurrences] int32 flat b*L+i, ascending

    @property
    def fully_resident(self) -> bool:
        return self.miss_rows.size == 0


# -- launch -------------------------------------------------------------------
def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def last_launch_info() -> dict:
    """Registers per thread, resident blocks per SM, spill bytes and
    geometry of the gather-and-pool instantiation launched last."""
    return library.launch_info("fused_lookup_last_launch_info",
                               kernel.LAUNCH_INFO_KEYS)


def _check_operands(cache, slots, rows, weights, hot):
    if cache.dim() != 3 or cache.dtype not in library.DTYPE_CODES \
            or cache.stride(2) != 1:
        raise ValueError(f"cache must be [T, C, D] float32/bfloat16 with "
                         f"contiguous rows, got {tuple(cache.shape)} "
                         f"{cache.dtype} strides {cache.stride()}")
    for name, x in (("slots", slots), ("rows", rows)):
        if (x.dim() != 3 or x.dtype != torch.int32 or not x.is_contiguous()
                or x.device != cache.device
                or x.shape[1] > cache.shape[0]):
            raise ValueError(f"{name} must be contiguous int32 [B, T<="
                             f"{cache.shape[0]}, L] on {cache.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if rows.shape != slots.shape:
        raise ValueError(f"rows {tuple(rows.shape)} != slots "
                         f"{tuple(slots.shape)}")
    if weights is not None and (
            weights.shape != slots.shape or weights.dtype != torch.float32
            or not weights.is_contiguous() or weights.device != cache.device):
        raise ValueError(f"weights must be contiguous float32 "
                         f"{tuple(slots.shape)} on {cache.device}")
    if hot is not None and (
            hot.dim() != 3 or hot.dtype != cache.dtype or hot.stride(2) != 1
            or hot.shape[0] < slots.shape[1] or hot.shape[2] != cache.shape[2]
            or hot.device != cache.device):
        raise ValueError(f"hot must be [T, K, {cache.shape[2]}] "
                         f"{cache.dtype} with contiguous rows on "
                         f"{cache.device}, got {tuple(hot.shape)} {hot.dtype}")


def pool_tables(cache: torch.Tensor, slots: torch.Tensor,
                rows: torch.Tensor, weights: torch.Tensor | None,
                hot: torch.Tensor | None, num_rows: int,
                opts: FusedLookupOpts):
    """One launch of the gather-and-pool kernel over every table.

    Returns (pooled [B, T, D] raw sums, bag_miss [T, B] MISS counts per
    bag, bitmap [T, ceil(R/32)] of the missing rows) on the device; the
    last two are what `list_tables` turns into the miss lists."""
    opts.validate()
    if not cache.is_cuda:
        raise ValueError("the fused lookup kernel needs tensors on a CUDA "
                         "device; CPU tensors go to fused_warm_lookup_plain")
    _check_operands(cache, slots, rows, weights, hot)
    if not 0 <= num_rows < 2 ** 31:
        raise ValueError(f"num_rows {num_rows} outside [0, 2^31)")
    batch, num_tables, pooling = slots.shape
    dim = cache.shape[2]
    dev = cache.device
    words = max(1, -(-num_rows // 32))
    pooled = torch.empty((batch, num_tables, dim), dtype=cache.dtype,
                         device=dev)
    bag_miss = torch.zeros((num_tables, batch), dtype=torch.int32, device=dev)
    bitmap = torch.zeros((num_tables, words), dtype=torch.int32, device=dev)
    if pooled.numel() == 0:
        return pooled, bag_miss, bitmap
    num_hot = 0 if hot is None else hot.shape[1]
    library.launch(
        "fused_lookup_pool", dev,
        cache.data_ptr(), cache.stride(0), cache.stride(1), cache.shape[1],
        None if hot is None else hot.data_ptr(),
        0 if hot is None else hot.stride(0),
        0 if hot is None else hot.stride(1), num_hot, num_rows,
        slots.data_ptr(), rows.data_ptr(),
        None if weights is None else weights.data_ptr(),
        pooled.data_ptr(), bag_miss.data_ptr(), bitmap.data_ptr(),
        words, batch, num_tables, pooling, dim,
        library.DTYPE_CODES[cache.dtype], opts.batch_block,
        opts.prefetch_distance)
    _count_launch()
    return pooled, bag_miss, bitmap


def list_tables(slots: torch.Tensor, rows: torch.Tensor,
                bag_miss: torch.Tensor, bitmap: torch.Tensor, num_rows: int):
    """One launch of the miss-list kernel over `pool_tables`' bag counts
    and bitmap (one block per table, on the same stream).

    Returns (miss_rows [T, cap], miss_pos [T, cap], counts [T, 2]) on the
    device; only the first counts[t, 0] / counts[t, 1] entries of a
    table's lists are defined."""
    batch, num_tables, pooling = slots.shape
    dev = slots.device
    cap = max(1, batch * pooling)
    miss_rows = torch.empty((num_tables, cap), dtype=torch.int32, device=dev)
    miss_pos = torch.empty((num_tables, cap), dtype=torch.int32, device=dev)
    counts = torch.zeros((num_tables, 2), dtype=torch.int32, device=dev)
    if batch * num_tables == 0:
        return miss_rows, miss_pos, counts
    library.launch(
        "fused_lookup_lists", dev,
        slots.data_ptr(), rows.data_ptr(), num_rows, bag_miss.data_ptr(),
        bitmap.data_ptr(), bitmap.shape[1], miss_rows.data_ptr(),
        miss_pos.data_ptr(), counts.data_ptr(), cap, batch, num_tables,
        pooling)
    return miss_rows, miss_pos, counts


def launch_tables(cache: torch.Tensor, slots: torch.Tensor,
                  rows: torch.Tensor, weights: torch.Tensor | None,
                  hot: torch.Tensor | None, num_rows: int,
                  opts: FusedLookupOpts):
    """The kernel pair over every table: `pool_tables`, then `list_tables`.

    Returns (pooled [B, T, D] raw sums, miss_rows [T, cap], miss_pos
    [T, cap], counts [T, 2]) on the device."""
    pooled, bag_miss, bitmap = pool_tables(cache, slots, rows, weights, hot,
                                           num_rows, opts)
    return (pooled, *list_tables(slots, rows, bag_miss, bitmap, num_rows))


def lists_to_host(miss_rows: torch.Tensor, miss_pos: torch.Tensor,
                   counts: torch.Tensor):
    """Copy the counts first, then only each table's live prefix of the
    lists (one device-side concatenation per list, one copy each) — never
    the [T, B·L] capacity buffers."""
    n = counts.cpu().numpy().astype(np.int64)                # [T, 2]
    num_tables = n.shape[0]
    rows_flat = torch.cat([miss_rows[t, :n[t, 0]] for t in range(num_tables)])
    pos_flat = torch.cat([miss_pos[t, :n[t, 1]] for t in range(num_tables)])
    rows_np = rows_flat.cpu().numpy()
    pos_np = pos_flat.cpu().numpy()
    rows_out = np.split(rows_np, np.cumsum(n[:, 0])[:-1])
    pos_out = np.split(pos_np, np.cumsum(n[:, 1])[:-1])
    return rows_out, pos_out


# -- plain version ------------------------------------------------------------
def fused_warm_lookup_plain(cache: torch.Tensor, slots, rows,
                            weights=None, hot=None, *, mode: str = "sum",
                            num_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch fused dataflow: [C, D] x slot map [B, L] -> pooled
    [B, D] (the counterpart of the TPU path's `fused_warm_lookup_xla`).

    Gather, select, multiply, `sum(dim=1)` and a late divide, in the
    reference's order. Returns only the pooled block; the miss list comes
    from `_miss_list_from_slots`. A slot >= K + C, or (with `num_rows`) a
    MISS whose row lies outside [0, num_rows), makes its bag NaN, as the
    kernel does."""
    dev = cache.device
    cache_rows, dim = cache.shape
    num_hot = 0 if hot is None else int(hot.shape[0])
    slots = torch.as_tensor(np.asarray(slots) if not torch.is_tensor(slots)
                            else slots, device=dev).long()
    if cache_rows == 0:
        # zero-capacity cache: a 1-row dummy keeps the gather well formed;
        # no valid slot can address it
        cache = torch.zeros((1, dim), dtype=cache.dtype, device=dev)
    warm_slot = (slots - num_hot).clamp(0, max(cache_rows - 1, 0))
    zero = torch.zeros((), dtype=cache.dtype, device=dev)
    gathered = torch.where((slots >= num_hot)[..., None], cache[warm_slot],
                           zero)                                  # [B, L, D]
    if num_hot:
        hot_slot = slots.clamp(0, num_hot - 1)
        is_hot = (slots >= 0) & (slots < num_hot)
        gathered = torch.where(is_hot[..., None], hot[hot_slot], gathered)
    bad = slots >= num_hot + cache_rows
    if num_rows is not None:
        r = torch.as_tensor(np.asarray(rows) if not torch.is_tensor(rows)
                            else rows, device=dev).long()
        bad |= (slots == MISS) & ((r < 0) | (r >= num_rows))
    if bool(bad.any()):
        gathered = torch.where(bad[..., None],
                               torch.full((), float("nan"),
                                          dtype=cache.dtype, device=dev),
                               gathered)
    w = None
    if weights is not None:
        w = torch.as_tensor(weights, device=dev)
        gathered = gathered * w[..., None].to(gathered.dtype)
    out = gathered.sum(dim=1)
    return mean_epilogue(out, w, slots.shape[1], mode)


def mean_epilogue(pooled: torch.Tensor, weights, pooling: int,
                  mode: str) -> torch.Tensor:
    """Raw sums -> the pooled result of `mode`. A weighted mean divides by
    max(Σw, 1e-9), an unweighted one by L, as `ref.embedding_bag_ref` and
    the embedding-bag kernel do, in f32 (a bf16 sum is widened, divided,
    and rounded once more). L is a tensor operand on the pooled device: a
    true division, where a Python scalar would let the card multiply by its
    reciprocal and miss the kernel's quotient by an ulp."""
    if mode == "sum":
        return pooled
    if mode != "mean":
        raise ValueError(f"unknown mode {mode!r}")
    raw = pooled.float()
    if weights is not None:
        denom = weights.float().sum(dim=-1).clamp_min(1e-9)[..., None]
        return (raw / denom).to(pooled.dtype)
    return (raw / torch.full((), pooling, dtype=torch.float32,
                             device=pooled.device)).to(pooled.dtype)


def _miss_list_from_slots(slots, rows, num_rows: int | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side miss-list oracle: (sorted distinct rows, ascending flat
    occurrence positions) for slot == MISS entries. PAD entries are silent;
    with `num_rows`, a MISS whose row lies outside [0, num_rows) is bad
    input and left out, as the kernel leaves it out."""
    flat_slots = np.asarray(slots).ravel()
    flat_rows = np.asarray(rows).ravel()
    miss = flat_slots == MISS
    if num_rows is not None:
        miss &= (flat_rows >= 0) & (flat_rows < num_rows)
    pos = np.flatnonzero(miss).astype(np.int32)
    if pos.size == 0:
        return np.empty(0, np.int32), pos
    return np.unique(flat_rows[pos]).astype(np.int32), pos


# -- wrappers -----------------------------------------------------------------
def fused_warm_lookup_tables(cache: torch.Tensor, slots: torch.Tensor,
                             rows: torch.Tensor, weights=None, hot=None, *,
                             num_rows: int,
                             opts: FusedLookupOpts | None = None):
    """Every table at once: cache [T, C, D], slots/rows [B, T, L] int32,
    weights [B, T, L] or None, hot [T, K, D] or None -> (pooled [B, T, D]
    raw sums, miss_rows list of T arrays, miss_pos list of T arrays).

    On the card: ONE launch of the kernel pair (`launch_tables`), then the
    live prefixes of the lists copied back (`lists_to_host`). On the CPU:
    the plain version per table."""
    if cache.is_cuda:
        pooled, mrow, mpos, counts = launch_tables(
            cache, slots, rows, weights, hot, num_rows,
            opts or FusedLookupOpts())
        return (pooled, *lists_to_host(mrow, mpos, counts))
    pooled, miss_rows, miss_pos = [], [], []
    slots_np, rows_np = np.asarray(slots), np.asarray(rows)
    for t in range(slots.shape[1]):
        pooled.append(fused_warm_lookup_plain(
            cache[t], slots[:, t], rows[:, t],
            None if weights is None else weights[:, t],
            None if hot is None else hot[t], num_rows=num_rows))
        r, p = _miss_list_from_slots(slots_np[:, t], rows_np[:, t], num_rows)
        miss_rows.append(r)
        miss_pos.append(p)
    return torch.stack(pooled, dim=1), miss_rows, miss_pos


def fused_warm_lookup(cache: torch.Tensor, slots, rows, weights=None,
                      hot=None, *, mode: str = "sum", backend: str = "auto",
                      opts: FusedLookupOpts | None = None
                      ) -> FusedLookupResult:
    """Fused warm-cache lookup: [C, D] x slot map [B, L] -> FusedLookupResult.

    `backend`: 'cuda' launches the kernel (the cache must lie on a CUDA
    device), 'plain' runs `fused_warm_lookup_plain`, 'auto' picks by the
    cache's device. `rows` are read on the host for R = max(rows) + 1, the
    extent of the kernel's miss bitmap."""
    backend = resolve_backend(backend, cache)
    slots_np = np.asarray(slots.cpu() if torch.is_tensor(slots) else slots)
    rows_np = np.asarray(rows.cpu() if torch.is_tensor(rows) else rows)
    batch, pooling = slots_np.shape
    dev = cache.device
    w = None if weights is None else torch.as_tensor(
        weights, dtype=torch.float32, device=dev)
    if pooling == 0:
        # empty bags: the reference formula on an empty gather (sum -> 0,
        # unweighted mean -> 0/0) with no misses to report
        pooled = mean_epilogue(
            torch.zeros((batch, cache.shape[1]), dtype=cache.dtype,
                        device=dev), w, 0, mode)
        return FusedLookupResult(pooled, np.empty(0, np.int32),
                                 np.empty(0, np.int32))
    num_rows = max(int(rows_np.max()) + 1, 0) if rows_np.size else 0
    if backend == "plain":
        pooled = fused_warm_lookup_plain(cache, slots_np, rows_np, w, hot,
                                         mode=mode, num_rows=num_rows)
        miss_rows, miss_pos = _miss_list_from_slots(slots_np, rows_np,
                                                    num_rows)
        return FusedLookupResult(pooled, miss_rows, miss_pos)
    as_dev = lambda x: torch.as_tensor(                     # noqa: E731
        x, dtype=torch.int32).to(dev)[:, None].contiguous()
    pooled, miss_rows, miss_pos = fused_warm_lookup_tables(
        cache[None], as_dev(slots_np), as_dev(rows_np),
        None if w is None else w[:, None].contiguous(),
        None if hot is None else hot[None], num_rows=num_rows, opts=opts)
    pooled = mean_epilogue(pooled[:, 0], w, pooling, mode)
    return FusedLookupResult(pooled, miss_rows[0], miss_pos[0])


def pool_bag_rows(bag_rows, weights=None, *, mode: str = "sum",
                  device=None) -> torch.Tensor:
    """Pool whole bags whose rows are given: [n, L, D] (+ weights [n, L])
    -> [n, D] on `device` (default: the rows' device).

    On the card this is ONE launch of the embedding-bag kernel over the
    bag rows as a [1, n·L, D] table with indices arange(n·L).view(n, 1, L),
    so a bag pooled here equals, bit for bit, the same bag pooled by the
    device backend. On the CPU it is the plain reduction of
    `core.embedding._pool_rows_core`."""
    rows = torch.as_tensor(bag_rows)
    dev = torch.device(device) if device is not None else rows.device
    rows = rows.to(dev)
    w = None if weights is None else torch.as_tensor(
        weights, dtype=torch.float32).to(dev)
    n, pooling, dim = rows.shape
    if dev.type != "cuda":
        from repro_torch.core.embedding import _pool_rows_core
        return _pool_rows_core(rows[:, None], None if w is None
                               else w[:, None], mode)[:, 0]
    idx = torch.arange(n * pooling, dtype=torch.int32,
                       device=dev).view(n, 1, pooling)
    return kernel.embedding_bag_cuda(
        rows.reshape(1, n * pooling, dim).contiguous(), idx,
        None if w is None else w.reshape(n, 1, pooling).contiguous(),
        dataclasses.replace(COMPLETION_OPTS, mode=mode))[:, 0]


def complete_miss_bags(pooled: torch.Tensor, bag_ids, bag_rows,
                       weights=None, *, mode: str = "sum") -> torch.Tensor:
    """Cold-path completion: RECOMPUTE miss-containing bags whole.

    pooled:   [B, D] the fused launch's partial output
    bag_ids:  [nb] bag indices that contained >= 1 miss
    bag_rows: [nb, L, D] the FULL row values of those bags, in position
              order (hits re-read from any tier: all tiers hold the same
              bytes; misses from the cold gather)
    weights:  [B, L] (full batch; this helper slices) or None

    Adding cold rows to the partial sums would change the summation order;
    rebuilding the bags through `pool_bag_rows` keeps the completed output
    bit-identical to the dense path. Returns a new tensor."""
    bag_ids = np.asarray(bag_ids)
    if bag_ids.size == 0:
        return pooled
    ids = torch.as_tensor(bag_ids, dtype=torch.long, device=pooled.device)
    w = None
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=pooled.device)[ids]
    vals = pool_bag_rows(bag_rows, w, mode=mode, device=pooled.device)
    return pooled.index_copy(0, ids, vals.to(pooled.dtype))
