"""HSTU generative ranking (Zhai et al., arXiv:2402.17152, §3) in plain
PyTorch, each user alone: the yardstick of the port's CPU tests
(`tests/test_torch_hstu.py`).

A user's tokens are each engagement's item row and action row, in order,
then the user's candidates' item rows; a token's time is its engagement's,
a candidate's its request's. Every layer, with LNs that have no affine,

    U, V, Q, K = split(SiLU(LN(X) @ W_uvqk))
    A_ij = SiLU(alpha q_i.k_j + p[j - i + N - 1] + w[bucket(t_i - t_j)])
           / N * mask(i, j)
    X'   = X + (LN(A V) * U) @ W_o + b_o

with alpha = 1/sqrt(d_qk), bucket(dt) = clamp(floor(ln(max(|dt|, 1)) /
0.301), 0, B) in double precision, and a mask that lets a history token
see the history up to itself and a candidate the whole history and itself.
Each candidate's last state goes through the task MLP (ReLU after every
layer but the last) to one logit. Weights are [in, out].

Float32 with TF32 off, dense [n, n] scores a head, no kernel and no
batching; it imports nothing of `repro` or `repro_torch`.
"""
from __future__ import annotations

import contextlib
import math

import torch

QUERY_BLOCK = 1024         # query rows of one block of scores
BUCKET_BASE = 0.301


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 in matrix products on or off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def time_bucket(dt: torch.Tensor, buckets: int) -> torch.Tensor:
    x = dt.abs().clamp_min(1).double()
    return (torch.log(x) / BUCKET_BASE).floor().clamp(0, buckets).long()


def attention(q, k, v, t, layer, cfg: dict, n_h: int) -> torch.Tensor:
    """One user's attention: q, k [h, n, d_qk], v [h, n, d_v], t [n] ->
    [n, h d_v]."""
    heads, n = q.shape[0], q.shape[1]
    big_n = cfg["max_seq_len"]
    alpha = 1.0 / math.sqrt(cfg["d_qk"])
    out = []
    j = torch.arange(n, device=q.device)[None, :]
    for i0 in range(0, n, QUERY_BLOCK):
        i = torch.arange(i0, min(n, i0 + QUERY_BLOCK), device=q.device)[:, None]
        rab = (layer["pos_bias"][j - i + big_n - 1]
               + layer["time_bias"][time_bucket(t[i] - t[j],
                                                cfg["time_buckets"])])
        mask = torch.where(i < n_h, j <= i, (j < n_h) | (j == i))
        s = q[:, i0:i0 + QUERY_BLOCK] @ k.transpose(1, 2)
        a = silu(alpha * s + rab) / big_n * mask
        out.append(a @ v)                              # [h, qb, d_v]
    return torch.cat(out, dim=1).transpose(0, 1).reshape(n, -1)


def user_states(x: torch.Tensor, t: torch.Tensor, layers, cfg: dict,
                n_h: int) -> torch.Tensor:
    """One user's tokens x [n, d] through every layer -> [n, d]."""
    heads, d_qk, d_v = cfg["heads"], cfg["d_qk"], cfg["d_v"]
    n = x.shape[0]
    for layer in layers:
        uvqk = silu(layer_norm(x, cfg["eps"]) @ layer["w_uvqk"])
        u, v, q, k = torch.split(uvqk, [heads * d_v, heads * d_v,
                                        heads * d_qk, heads * d_qk], dim=1)
        o = attention(q.reshape(n, heads, d_qk).transpose(0, 1),
                      k.reshape(n, heads, d_qk).transpose(0, 1),
                      v.reshape(n, heads, d_v).transpose(0, 1), t, layer,
                      cfg, n_h)
        x = x + ((layer_norm(o, cfg["eps"]) * u) @ layer["w_o"]
                 + layer["b_o"])
    return x


def forward(tables: torch.Tensor, layers, head, cfg: dict, events,
            candidates, item_ids: torch.Tensor, action_ids: torch.Tensor,
            timestamps: torch.Tensor):
    """tables [item_rows + action_rows, d] (items, then actions); events
    and candidates, a count a user; item_ids [E + C], action_ids [E],
    timestamps [E + C] (every user's engagements, then every user's
    candidates) -> (the last layer's states [2E + C, d] float32, every
    user's history rows then every user's candidates; logits [C])."""
    num_events = sum(events)
    hist_total = 2 * num_events
    items = tables[:cfg["item_rows"]]
    actions = tables[cfg["item_rows"]:]
    states = torch.empty((hist_total + sum(candidates), tables.shape[1]),
                         dtype=torch.float32, device=tables.device)
    e0 = c0 = 0
    with matmul_precision(False):
        for e, m in zip(events, candidates):
            ev = slice(e0, e0 + e)
            cand = slice(num_events + c0, num_events + c0 + m)
            hist = torch.stack([items[item_ids[ev].long()],
                                actions[action_ids[ev].long()]], dim=1)
            x = torch.cat([hist.reshape(2 * e, -1),
                           items[item_ids[cand].long()]]).float()
            t = torch.cat([timestamps[ev].repeat_interleave(2),
                           timestamps[cand]])
            out = user_states(x, t, layers, cfg, 2 * e)
            states[2 * e0:2 * (e0 + e)] = out[:2 * e]
            states[hist_total + c0:hist_total + c0 + m] = out[2 * e:]
            e0, c0 = e0 + e, c0 + m
        z = states[hist_total:]
        for i, (w, b) in enumerate(head):
            z = z @ w + b
            if i < len(head) - 1:
                z = torch.relu(z)
    return states, z[:, 0]
