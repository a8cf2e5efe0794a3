"""Mixture-of-experts FFN: routing, fixed-capacity dispatch, experts, combine.

The JAX package's `moe.py`: tokens are scattered into an [E, C, d]
buffer. Over-capacity tokens are dropped (`moe_capacity_factor` sets the
margin; `moe_aux_stats` reports the realized drop rate). With
`ctx.ep_size > 1` (inside the `shard_map_compat` region that
`transformer._moe_apply` opens over the `model` axis) the experts are
sharded and each rank's buffer goes to the experts' owners by an
all-to-all and back (`_functional_collectives.all_to_all_single`, the
autograd form, so a train step differentiates through it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class MoEContext:
    """Named-axis context of the expert-parallel path; ep_size==1 => local."""
    ep_axis: str = "model"
    ep_size: int = 1
    mesh: object = None


def moe_init(cfg: ModelConfig, *, generator, device) -> dict:
    d, e = cfg.d_model, cfg.moe_num_experts
    f = cfg.moe_d_ff
    dt = cfg.torch_dtype

    def init(shape, dtype=dt, scale=None):
        return dense_init(shape, dtype, generator=generator, device=device,
                          scale=scale)
    p = {
        "router": init((d, e), torch.float32, scale=0.02),
        "wi": init((e, d, f)),
        "wg": init((e, d, f)),
        "wo": init((e, f, d)),
    }
    if cfg.moe_num_shared:
        fs = cfg.moe_num_shared * f
        p["shared"] = {"wi": init((d, fs)), "wg": init((d, fs)),
                       "wo": init((fs, d))}
    return p


def _route(router_w, x, top_k: int):
    """x: [T, d] -> (weights [T,k], experts [T,k] int64).

    Ties go to the lower expert index, as in `jax.lax.top_k`: a stable
    descending sort keeps equal probabilities in index order."""
    logits = x.float() @ router_w                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return top_w, top_e


def _dispatch_local(x, top_w, top_e, num_experts: int, capacity: int):
    """Scatter tokens into a fixed-capacity [E, C, d] buffer.

    Returns (buffer [E,C,d], combine info (tok_id, expert, pos, w, keep)).
    A token's position in its expert counts the earlier (token-major)
    assignments to that expert; `keep = pos < capacity`.
    """
    t, k = top_e.shape
    flat_e = top_e.reshape(-1)                             # [T*k]
    flat_w = top_w.reshape(-1)
    tok_id = torch.arange(t, device=x.device).repeat_interleave(k)
    onehot = (flat_e[:, None] == torch.arange(
        num_experts, device=x.device)[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = (pos * onehot).sum(-1)                           # [T*k]
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, capacity - 1).long()
    buf = torch.zeros((num_experts, capacity, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    contrib = torch.where(keep[:, None], x[tok_id], 0)
    # accumulating, as `buf.at[].add`: a dropped token adds zeros to the
    # last slot, and at most one kept token lands in each slot
    buf.index_put_((flat_e, safe_pos), contrib, accumulate=True)
    return buf, (tok_id, flat_e, safe_pos, flat_w, keep)


def _expert_ffn(wi, wg, wo, h):
    """h: [E_loc, C', d] -> [E_loc, C', d] (per-expert SwiGLU)."""
    a = torch.einsum("ecd,edf->ecf", h, wi)
    g = F.silu(torch.einsum("ecd,edf->ecf", h, wg))
    return torch.einsum("ecf,efd->ecd", a * g, wo)


def _combine_local(y_buf, info, num_tokens: int):
    tok_id, flat_e, pos, w, keep = info
    rows = y_buf[flat_e, pos]                              # [T*k, d]
    rows = torch.where(keep[:, None], rows, 0) * w[:, None].to(y_buf.dtype)
    # tok_id is token-major (each token's k rows are adjacent), so the
    # segment sum is a sum over k
    return rows.reshape(num_tokens, -1, rows.shape[-1]).sum(1)


def moe_ffn_local(params, cfg: ModelConfig, x2d: torch.Tensor,
                  ctx: Optional[MoEContext] = None) -> torch.Tensor:
    """Runs on the *local* token shard: x2d [T_local, d] -> [T_local, d].
    With ctx.ep_size > 1 (plain local tensors inside the region; the
    expert weights are this rank's [E_loc, ...] shard) it performs the EP
    all-to-all over `ctx.mesh`'s `ctx.ep_axis` group; otherwise
    single-shard dense dispatch."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    t = x2d.shape[0]
    cap = max(1, int(t * k / e * cfg.moe_capacity_factor))
    top_w, top_e = _route(params["router"], x2d, k)
    buf, info = _dispatch_local(x2d, top_w, top_e, e, cap)   # [E, C, d]
    if ctx is not None and ctx.ep_size > 1:
        y_buf = _expert_parallel(params, buf, ctx, e, cap)
    else:
        y_buf = _expert_ffn(params["wi"], params["wg"], params["wo"], buf)
    out = _combine_local(y_buf, info, t)
    if "shared" in params:
        sh = params["shared"]
        out = out + (F.silu(x2d @ sh["wg"]) * (x2d @ sh["wi"])) @ sh["wo"]
    return out.to(x2d.dtype)


def _all_to_all(x: torch.Tensor, ctx: MoEContext) -> torch.Tensor:
    """JAX's `all_to_all(split_axis=0, concat_axis=0, tiled=False)` over
    the `ctx.ep_axis` group: block r of dim 0 goes to rank r, and block r
    of the result came from rank r."""
    from torch.distributed import _functional_collectives as funcol
    group = ctx.mesh.get_group(ctx.ep_axis)
    return funcol.all_to_all_single_autograd(x.contiguous(), None, None,
                                             group)


def _expert_parallel(params, buf, ctx: MoEContext, e: int, cap: int):
    r = ctx.ep_size
    e_loc = e // r
    if params["wi"].shape[0] != e_loc:
        raise ValueError(f"EP expects the local expert shard {e_loc}, "
                         f"got {params['wi'].shape[0]}")
    # [E, C, d] -> [R, E_loc, C, d]; exchange: dim 0 becomes source rank
    recv = _all_to_all(buf.reshape(r, e_loc, cap, -1), ctx)
    h = recv.movedim(0, 1).reshape(e_loc, r * cap, -1)
    y = _expert_ffn(params["wi"], params["wg"], params["wo"], h)
    y = y.reshape(e_loc, r, cap, -1).movedim(1, 0)
    return _all_to_all(y, ctx).reshape(e, cap, -1)


def moe_aux_stats(params, cfg: ModelConfig, x2d: torch.Tensor) -> dict:
    """Routing diagnostics: load balance + realized drop rate."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    t = x2d.shape[0]
    cap = max(1, int(t * k / e * cfg.moe_capacity_factor))
    top_w, top_e = _route(params["router"], x2d, k)
    _, (_, _, _, _, keep) = _dispatch_local(x2d, top_w, top_e, e, cap)
    counts = torch.bincount(top_e.reshape(-1), minlength=e).float()
    return {"drop_rate": 1.0 - keep.float().mean(),
            "max_load": counts.max() / torch.clamp_min(counts.mean(), 1e-9),
            "capacity": cap}
