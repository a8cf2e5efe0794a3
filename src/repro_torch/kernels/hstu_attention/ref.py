"""The plain version of HSTU's attention (`csrc/hstu_attention.cu`), the
time buckets both sides share, and the plain version of the kernel's time
codes.

Each user alone, with dense [n, n] scores a head: the scores, the relative
bias gathered from the position and time tables, SiLU, 1/N and the mask,
then A V. It is what the kernel computes, in plain `torch`, and
`kernel.hstu_attention` takes it for CPU tensors only. It runs on any
device when called directly (chip_smoke.py holds the kernel to it on the
card).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: the divisor of ln|dt| in HSTU's time buckets (the reference code's 0.301)
BUCKET_BASE = 0.301
TILE = 64             # the kernel's kBM = kBN: queries and keys of a tile
MASKED = 255          # the code of a pair the mask keeps out (kMasked)
MAX_BUCKETS = MASKED - 1  # codes are one byte


def time_bucket_of(x: float, buckets: int, base: float = BUCKET_BASE) -> int:
    """clamp(floor(ln(max(x, 1)) / base), 0, buckets) for one |dt|, in
    double precision."""
    return min(max(math.floor(math.log(max(x, 1)) / base), 0), buckets)


def bucket_thresholds(buckets: int, base: float = BUCKET_BASE) -> list[int]:
    """thresholds[b] = the least integer x >= 0 with `time_bucket_of(x) >=
    b`, for b = 0..buckets (thresholds[0] = 0): integer |dt| >=
    thresholds[b] and < thresholds[b + 1] lie in bucket b. Beyond 2**53 a
    double no longer tells integers apart, and the threshold is the rounded
    exp(base·b)."""
    out = [0]
    for b in range(1, buckets + 1):
        x = math.ceil(math.exp(base * b))
        if x < 2 ** 53:
            while x > 1 and time_bucket_of(x - 1, buckets, base) >= b:
                x -= 1
            while time_bucket_of(x, buckets, base) < b:
                x += 1
        out.append(x)
    return out


def time_bucket(delta: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Buckets of integer |dt| (int64, any shape) by the thresholds
    ([buckets + 1] int64, on delta's device)."""
    return torch.searchsorted(thresholds, delta.contiguous(), right=True) - 1


def user_rows(layout, device) -> list[torch.Tensor]:
    """Each user's token rows, history then candidates (the layout of
    `kernel.JaggedLayout`)."""
    hist_total = sum(layout.history)
    rows, h0, c0 = [], 0, 0
    for n_h, m in zip(layout.history, layout.candidates):
        rows.append(torch.cat([
            torch.arange(h0, h0 + n_h, device=device),
            torch.arange(hist_total + c0, hist_total + c0 + m,
                         device=device)]))
        h0, c0 = h0 + n_h, c0 + m
    return rows


def attention_mask(n_h: int, m: int, device) -> torch.Tensor:
    """[n, n] bool: history tokens see history causally; a candidate sees
    the whole history and itself."""
    n = n_h + m
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return torch.where(i < n_h, j <= i, (j < n_h) | (j == i))


def check_buckets(buckets: int) -> None:
    """Raise ValueError unless 0 <= buckets <= MAX_BUCKETS."""
    if not 0 <= buckets <= MAX_BUCKETS:
        raise ValueError(f"{buckets} time buckets; at most {MAX_BUCKETS} "
                         f"(codes are one byte, and {MASKED} marks the mask)")


def time_codes_ref(layout, times: torch.Tensor,
                   thresholds: torch.Tensor) -> torch.Tensor:
    """The kernel's time codes of a layout, uint8 [code tiles · 4096] on
    times' device: for each user of n tokens and T = ceil(n / 64), the
    [64 T, 64 T] codes (`time_bucket` of |t_i - t_j| where
    `attention_mask` lets the pair in, MASKED elsewhere and past n) as 64 x
    64 tiles, the lower triangle's tile (a, b) at a (a + 1) / 2 + b after
    the users before; inside a tile, code (ty + 16 r, tx + 16 c) at byte 16
    (16 ty + tx) + 4 r + c."""
    check_buckets(thresholds.shape[0] - 1)
    device = times.device
    out = [torch.zeros(0, dtype=torch.uint8, device=device)]
    for rows, n_h, m in zip(user_rows(layout, device), layout.history,
                            layout.candidates):
        n = n_h + m
        t = -(-n // TILE)
        codes = torch.full((t * TILE, t * TILE), MASKED, dtype=torch.uint8,
                           device=device)
        tu = times[rows]
        bucket = time_bucket((tu[:, None] - tu[None, :]).abs(), thresholds)
        codes[:n, :n] = torch.where(attention_mask(n_h, m, device), bucket,
                                    MASKED).to(torch.uint8)
        # [a, r, ty, b, c, tx] -> [a, b, ty, tx, r, c]
        tiles = codes.view(t, 4, 16, t, 4, 16).permute(0, 3, 2, 5, 1, 4)
        a, b = torch.tril_indices(t, t, device=device)
        out.append(tiles[a, b].reshape(-1))
    return torch.cat(out)


def hstu_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       layout, times: torch.Tensor, pos_bias: torch.Tensor,
                       time_bias: torch.Tensor, thresholds: torch.Tensor, *,
                       heads: int, max_seq_len: int) -> torch.Tensor:
    """q, k [rows, heads·d_qk], v [rows, heads·d_v] float32 (any row
    stride), times [rows] int64 -> [rows, heads·d_v] float32, each user
    alone."""
    rows_total = q.shape[0]
    d_qk, d_v = q.shape[1] // heads, v.shape[1] // heads
    out = q.new_zeros((rows_total, heads * d_v))
    alpha = d_qk ** -0.5
    for rows, n_h, m in zip(user_rows(layout, q.device), layout.history,
                            layout.candidates):
        n = n_h + m
        qu = q[rows].view(n, heads, d_qk).transpose(0, 1)
        ku = k[rows].view(n, heads, d_qk).transpose(0, 1)
        vu = v[rows].view(n, heads, d_v).transpose(0, 1)
        pos = torch.arange(n, device=q.device)
        t = times[rows]
        rab = (pos_bias[pos[None, :] - pos[:, None] + max_seq_len - 1]
               + time_bias[time_bucket((t[:, None] - t[None, :]).abs(),
                                       thresholds)])
        a = F.silu(alpha * (qu @ ku.transpose(1, 2)) + rab) / max_seq_len
        a = a * attention_mask(n_h, m, q.device)
        out[rows] = (a @ vu).transpose(0, 1).reshape(n, heads * d_v)
    return out
