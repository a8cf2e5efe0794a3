"""Exact maximum-inner-product search over a bf16 corpus: the CUDA kernel,
its plain version and the dispatch between them.

    ids[u], scores[u] = the k rows r of largest queries[u] . rows[r],
                        best first, ties to the smaller row

for up to `MAX_USERS` float32 queries at once: HSTU's retrieval stage
(Zhai et al., arXiv:2402.17152, §2.1), every row of the item table read
once a batch. `csrc/mips_topk.cu` replaces no TPU kernel (the JAX package
has no retrieval); a library computes it only by writing every score
(`torch.mm` on rows widened to f32, then `torch.topk`). Two launches a
call: the scan keeps each block's candidates in lists it hands to the
merge; no score reaches device memory. Built, bound and launched through
`kernels/library.py`, at first use; a failed build raises.

`mips_topk` takes the plain version (`ref.mips_topk_ref`, the kernel's
scores bit for bit) for CPU tensors and the kernel for CUDA tensors, with
no fallback between them.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import library
from repro_torch.kernels.mips_topk.ref import mips_topk_ref
from repro_torch.tracing import span

#: Kernel launches (two a call: the scan and the merge) and corpus rows
#: scanned since each count was last set to 0; only `mips_topk_cuda` adds
#: to them, once a call, under a lock.
LAUNCHES = 0
ROWS_SCANNED = 0
_COUNT_LOCK = threading.Lock()

MAX_USERS = 32             # queries the scan holds on chip
MAX_K = 1024
LIST_CAP = 2048            # keys of a (block, query) list
DIM_STEP = 16              # dims of a stage: d is a multiple of it
QUERY_BYTES = 64 * 1024    # the queries' shared memory, at most


LAUNCH_INFO_KEYS = ("registers", "blocks_per_sm", "local_bytes",
                    "static_shared_bytes", "dynamic_shared_bytes",
                    "queries_held", "grid")  # mips_topk_last_launch_info


def _count(rows: int) -> None:
    global LAUNCHES, ROWS_SCANNED
    with _COUNT_LOCK:
        LAUNCHES += 2
        ROWS_SCANNED += rows


def last_launch_info() -> dict:
    """Registers per thread, resident blocks per SM, spill bytes and the
    launch shape of the scan launched last."""
    return library.launch_info("mips_topk_last_launch_info",
                               LAUNCH_INFO_KEYS)


def check_args(queries: torch.Tensor, rows: torch.Tensor, k: int) -> None:
    """Raise ValueError unless queries [U, d] float32 and rows [R, d] are
    2-D on one device, 1 <= U <= MAX_USERS and 1 <= k <= min(R, MAX_K)."""
    if queries.dim() != 2 or rows.dim() != 2 \
            or queries.shape[1] != rows.shape[1]:
        raise ValueError(f"queries [U, d] and rows [R, d], got "
                         f"{tuple(queries.shape)} and {tuple(rows.shape)}")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    if queries.device != rows.device:
        raise ValueError(f"queries on {queries.device}, rows on "
                         f"{rows.device}")
    users = queries.shape[0]
    if not 1 <= users <= MAX_USERS:
        raise ValueError(f"{users} queries; the scan holds 1 to "
                         f"{MAX_USERS}")
    if not 1 <= k <= min(rows.shape[0], MAX_K):
        raise ValueError(f"k={k} for {rows.shape[0]} rows; 1 <= k <= "
                         f"min(rows, {MAX_K})")


def mips_topk_cuda(queries: torch.Tensor, rows: torch.Tensor, k: int):
    """One call of the kernel: two launches, the scan and the merge.

    queries:  [U, d] float32, contiguous, on a CUDA device
    rows:     [R, d] bfloat16 with contiguous rows of d, d a multiple of
              16 with 4 d Q bytes at most 64 KB (Q = 16 queries held for U
              up to 16, else 32), 16-byte aligned,
              R < 2**31, on the same device
    returns:  (ids [U, k] int32, scores [U, k] float32), best first
    """
    check_args(queries, rows, k)
    if not rows.is_cuda:
        raise ValueError(f"mips_topk_cuda needs tensors on a CUDA device, got "
                         f"{rows.device}; CPU tensors go to ref.mips_topk_ref")
    users, dim = queries.shape
    n_rows = rows.shape[0]
    held = 16 if users <= 16 else 32
    if (rows.dtype != torch.bfloat16 or not queries.is_contiguous()
            or rows.stride() != (dim, 1) or dim % DIM_STEP
            or 4 * dim * held > QUERY_BYTES or rows.data_ptr() % 16
            or n_rows >= 2 ** 31):
        raise ValueError(
            f"rows must be bfloat16 [R < 2**31, d] with contiguous rows, "
            f"16-byte aligned, d a multiple of {DIM_STEP} and 4 d "
            f"{held} <= {QUERY_BYTES}; queries contiguous; got rows "
            f"{tuple(rows.shape)} {rows.dtype} stride {rows.stride()}")
    device = rows.device
    # one scan block an SM at most (the launch takes fewer where the corpus
    # has fewer tiles); each holds a list a query
    grid = torch.cuda.get_device_properties(device).multi_processor_count
    lists = torch.empty(grid * users * LIST_CAP, dtype=torch.int64,
                        device=device)
    lengths = torch.empty(grid * users, dtype=torch.int32, device=device)
    ids = torch.empty((users, k), dtype=torch.int32, device=device)
    scores = torch.empty((users, k), dtype=torch.float32, device=device)
    library.launch("mips_topk_launch", device, queries.data_ptr(), users, dim,
                   rows.data_ptr(), n_rows, k, lists.data_ptr(),
                   lengths.data_ptr(), grid, ids.data_ptr(), scores.data_ptr())
    _count(n_rows)
    return ids, scores


def mips_topk(queries: torch.Tensor, rows: torch.Tensor, k: int):
    """The k best rows a query, under the span `hstu.mips`: the kernel for
    CUDA tensors, the plain version for CPU tensors, an error elsewhere.
    -> (ids [U, k] int32, scores [U, k] float32), best first."""
    with span("hstu.mips"):
        if rows.is_cuda:
            return mips_topk_cuda(queries, rows, k)
        if rows.device.type == "cpu":
            check_args(queries, rows, k)
            return mips_topk_ref(queries, rows, k)
        raise ValueError(f"no MIPS top-k for tensors on {rows.device}")
