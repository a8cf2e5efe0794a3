"""HSTU's pointwise attention over jagged user sequences: the CUDA kernels,
their plain versions and the dispatch between them.

    out_i = sum_j SiLU(alpha q_i.k_j + p[j - i + N - 1] + w[bucket(|t_i - t_j|)])
                  / N * mask(i, j) * v_j

for each user and head (Zhai et al., arXiv:2402.17152, §3), where a
history token sees the history causally and a candidate sees the whole
history and itself. `csrc/hstu_attention.cu` replaces no TPU kernel (the
JAX package has no HSTU): FlashAttention and `scaled_dot_product_attention`
assume a softmax and cannot compute it, and the plain version materialises
an [n, n] score matrix a head and computes every masked pair. The kernel
walks each query tile's key tiles up to its diagonal, skips the tiles that
the mask leaves empty, and fuses the bias gather, SiLU, 1/N and the mask.
Each pair's time bucket and mask depend on neither the head nor the layer:
`hstu_time_codes` codes them once a forward, one byte a pair
(`ref.time_codes_ref` is the layout), and every layer's launch reads the
codes. Both kernels are built, bound and launched through
`kernels/library.py`, at first use; a failed build raises.

`hstu_attention` takes the plain version (`ref.hstu_attention_ref`, which
buckets the times itself) for CPU tensors and the kernel for CUDA tensors,
with no fallback between them; there is no backward.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch.kernels import library
from repro_torch.kernels.hstu_attention.ref import (MAX_BUCKETS, TILE,
                                                    check_buckets,
                                                    hstu_attention_ref)
from repro_torch.tracing import span

#: Launches of the attention kernel, and of the time codes' build, since
#: each count was last set to 0; only `hstu_attention_cuda` and
#: `time_codes_cuda` add to them, once a launch, under a lock. A forward
#: builds once and launches once a layer: LAUNCHES / CODE_BUILDS is how
#: often each code is read. CODE_TILES: the 64 x 64 tiles of codes the
#: builds wrote.
LAUNCHES = 0
CODE_BUILDS = 0
CODE_TILES = 0
_COUNT_LOCK = threading.Lock()

HEAD_DIMS = (128,)         # the kernel's instantiations
TILE_BYTES = TILE * TILE   # codes of a 64 x 64 tile of pairs, one byte each


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def _count_build(tiles: int) -> None:
    global CODE_BUILDS, CODE_TILES
    with _COUNT_LOCK:
        CODE_BUILDS += 1
        CODE_TILES += tiles


LAUNCH_INFO_KEYS = ("registers", "blocks_per_sm", "local_bytes",
                    "static_shared_bytes", "dynamic_shared_bytes",
                    "head_dim", "grid")  # hstu_attention_last_launch_info


def last_launch_info() -> dict:
    """Registers per thread, resident blocks per SM, spill bytes and the
    launch shape of the kernel launched last: the attention's
    instantiation, or the build (head_dim 0)."""
    return library.launch_info("hstu_attention_last_launch_info",
                               LAUNCH_INFO_KEYS)


@dataclasses.dataclass(frozen=True)
class JaggedLayout:
    """Where each user's tokens are among the rows of a jagged batch.

    Every user's history tokens come first, in user order (user u's at
    rows [hist_offsets[u], hist_offsets[u + 1])), then every user's
    candidates, in user order, from row `hist_total`. `history` and
    `candidates` are the counts a user on the host, so that nothing is read
    back from the card; the offsets are their prefix sums as int32 tensors
    on the tokens' device."""

    history: tuple[int, ...]
    candidates: tuple[int, ...]
    hist_offsets: torch.Tensor
    cand_offsets: torch.Tensor

    def __post_init__(self):
        if len(self.history) != len(self.candidates):
            raise ValueError(f"{len(self.history)} histories and "
                             f"{len(self.candidates)} candidate counts")
        if min((*self.history, *self.candidates), default=0) < 0:
            raise ValueError("token counts must be >= 0")

    @property
    def users(self) -> int:
        return len(self.history)

    @property
    def hist_total(self) -> int:
        return sum(self.history)

    @property
    def rows(self) -> int:
        return self.hist_total + sum(self.candidates)

    def longest(self) -> int:
        return max((h + c for h, c in zip(self.history, self.candidates)),
                   default=0)

    def pairs(self) -> int:
        """(query, key) pairs the mask lets in, a head: n_h (n_h + 1) / 2
        in the history of each user, n_h + 1 for each candidate."""
        return sum(h * (h + 1) // 2 + c * (h + 1)
                   for h, c in zip(self.history, self.candidates))

    def code_tiles(self) -> int:
        """64 x 64 tiles of time codes: the lower triangle T (T + 1) / 2
        of each user's T = ceil(n / 64) query tiles, summed."""
        return sum(t * (t + 1) // 2 for t in
                   (-(-(h + c) // TILE)
                    for h, c in zip(self.history, self.candidates)))


def check_codes(codes, layout: JaggedLayout, device) -> None:
    """Raise ValueError unless `codes` is the layout's code buffer: uint8,
    contiguous, [layout.code_tiles() · TILE_BYTES], on `device`, 16-byte
    aligned."""
    n = layout.code_tiles() * TILE_BYTES
    if (not isinstance(codes, torch.Tensor) or codes.shape != (n,)
            or codes.dtype != torch.uint8 or not codes.is_contiguous()
            or codes.device != torch.device(device)
            or codes.data_ptr() % 16):
        got = (f"{tuple(codes.shape)} {codes.dtype} on {codes.device}"
               if isinstance(codes, torch.Tensor) else type(codes).__name__)
        raise ValueError(f"codes must be the layout's contiguous, 16-byte "
                         f"aligned uint8 [{n}] on {device} "
                         f"(hstu_time_codes), got {got}")


def time_codes_cuda(layout: JaggedLayout, times: torch.Tensor,
                    thresholds: torch.Tensor) -> torch.Tensor:
    """One launch of the build: every pair's time code of the layout.

    times:       [rows] int64, contiguous, on a CUDA device
    thresholds:  [B + 1] int64 (`ref.bucket_thresholds`), B <= MAX_BUCKETS,
                 on the same device; the offsets too
    returns:     [layout.code_tiles() · TILE_BYTES] uint8, laid out as
                 `ref.time_codes_ref`
    """
    device = times.device
    buckets = thresholds.shape[0] - 1 if thresholds.dim() == 1 else -1
    for name, t, dtype, n in (
            ("times", times, torch.int64, layout.rows),
            ("thresholds", thresholds, torch.int64, buckets + 1),
            ("hist_offsets", layout.hist_offsets, torch.int32,
             layout.users + 1),
            ("cand_offsets", layout.cand_offsets, torch.int32,
             layout.users + 1)):
        if (t.shape != (n,) or t.dtype != dtype or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name} must be contiguous {dtype} [{n}] on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    check_buckets(buckets)
    if not times.is_cuda:
        raise ValueError(f"time_codes_cuda needs times on a CUDA device, got "
                         f"{device}; on the CPU the plain attention buckets "
                         f"the times itself")
    tiles = layout.code_tiles()
    codes = torch.empty(tiles * TILE_BYTES, dtype=torch.uint8, device=device)
    if tiles == 0:
        return codes
    library.launch(
        "hstu_time_codes_launch", device, layout.hist_offsets.data_ptr(),
        layout.cand_offsets.data_ptr(), layout.users, layout.hist_total,
        times.data_ptr(), thresholds.data_ptr(), buckets, codes.data_ptr(),
        tiles)
    _count_build(tiles)
    return codes


def hstu_time_codes(layout: JaggedLayout, times: torch.Tensor,
                    thresholds: torch.Tensor):
    """A forward's time codes, which each layer's `hstu_attention` takes:
    for CUDA tensors the build's buffer, under the span `hstu.time_codes`;
    for CPU tensors (times, thresholds) as they are, which the plain
    attention buckets itself; an error elsewhere."""
    if times.device.type == "cpu":
        return times, thresholds
    if not times.is_cuda:
        raise ValueError(f"no HSTU time codes for tensors on {times.device}")
    with span("hstu.time_codes"):
        return time_codes_cuda(layout, times, thresholds)


def hstu_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: JaggedLayout, codes: torch.Tensor,
                        pos_bias: torch.Tensor, time_bias: torch.Tensor, *,
                        heads: int, max_seq_len: int) -> torch.Tensor:
    """One launch of the CUDA kernel.

    q, k, v:     [rows, heads·D] float32 on a CUDA device with contiguous
                 columns and one row stride, 16-byte aligned (column blocks
                 of one buffer may share it); D in HEAD_DIMS
    codes:       the layout's time codes (`time_codes_cuda`), built with
                 the thresholds of the same B
    pos_bias:    [2N - 1] and time_bias [B + 1] float32, B <= MAX_BUCKETS;
                 all contiguous, on the same device
    returns:     [rows, heads·D] float32
    """
    device = q.device
    if not (q.is_cuda and k.device == device and v.device == device):
        raise ValueError(f"hstu_attention_cuda needs q, k and v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}; "
                         f"CPU tensors go to ref.hstu_attention_ref")
    rows, width = q.shape if q.dim() == 2 else (-1, -1)
    if (any(t.dim() != 2 or t.shape != (rows, width)
            or t.dtype != torch.float32 or t.stride(1) != 1
            or t.stride(0) != q.stride(0) for t in (q, k, v))
            or width % heads or width // heads not in HEAD_DIMS):
        raise ValueError(f"q, k and v must be float32 [rows, heads·D] with "
                         f"contiguous columns and one row stride, D in "
                         f"{HEAD_DIMS}, heads={heads}; got "
                         f"{[(tuple(t.shape), t.dtype, t.stride()) for t in (q, k, v)]}")
    if rows != layout.rows:
        raise ValueError(f"{rows} rows for a layout of {layout.rows}")
    if layout.longest() > max_seq_len:
        raise ValueError(f"a sequence of {layout.longest()} tokens is longer "
                         f"than max_seq_len={max_seq_len}")
    buckets = time_bias.shape[0] - 1 if time_bias.dim() == 1 else -1
    for name, t, dtype, n in (
            ("pos_bias", pos_bias, torch.float32, 2 * max_seq_len - 1),
            ("time_bias", time_bias, torch.float32, buckets + 1),
            ("hist_offsets", layout.hist_offsets, torch.int32,
             layout.users + 1),
            ("cand_offsets", layout.cand_offsets, torch.int32,
             layout.users + 1)):
        if (t.shape != (n,) or t.dtype != dtype or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name} must be contiguous {dtype} [{n}] on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    check_buckets(buckets)
    check_codes(codes, layout, device)
    if any(t.data_ptr() % 16 for t in (q, k, v)) or q.stride(0) % 4:
        raise ValueError("q, k and v must be 16-byte aligned, with a row "
                         "stride a multiple of 4")
    out = torch.empty((rows, width), dtype=torch.float32, device=device)
    tiles = -(-layout.longest() // TILE)
    if rows == 0 or tiles == 0:
        return out
    library.launch(
        "hstu_attention_launch", device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), q.stride(0), layout.hist_offsets.data_ptr(),
        layout.cand_offsets.data_ptr(), layout.users, layout.hist_total,
        codes.data_ptr(), pos_bias.data_ptr(), time_bias.data_ptr(), buckets,
        out.data_ptr(), out.stride(0), heads, width // heads, max_seq_len,
        tiles)
    _count_launch()
    return out


def hstu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   layout: JaggedLayout, codes, pos_bias: torch.Tensor,
                   time_bias: torch.Tensor, *, heads: int,
                   max_seq_len: int) -> torch.Tensor:
    """The attention of one layer, under the span `hstu.attention`, on the
    forward's `codes` (`hstu_time_codes`): the kernel for CUDA tensors,
    which reads the build's buffer; the plain version for CPU tensors,
    which buckets the (times, thresholds) it is given; an error
    elsewhere."""
    with span("hstu.attention"):
        if q.is_cuda:
            return hstu_attention_cuda(q, k, v, layout, codes, pos_bias,
                                       time_bias, heads=heads,
                                       max_seq_len=max_seq_len)
        if q.device.type == "cpu":
            times, thresholds = codes
            return hstu_attention_ref(q, k, v, layout, times, pos_bias,
                                      time_bias, thresholds, heads=heads,
                                      max_seq_len=max_seq_len)
        raise ValueError(f"no HSTU attention for tensors on {q.device}")
