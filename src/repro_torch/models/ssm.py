"""State-space / linear-attention blocks: Mamba (Jamba) and RWKV-6 (Finch).

Both expose a sequence form (train/prefill; chunked parallel scan for Mamba,
chunked WKV for RWKV) and a single-step decode form carrying O(1) state.
States are tensors updated in place when given; each call still returns
them.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, split_heads
from repro_torch.models.pspec import P
from repro_torch.utils import shard_map_compat


# ---------------------------------------------------------------------------
# Mamba (S6 selective scan), chunked associative scan
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    h: torch.Tensor         # [B, d_inner, state]
    conv: torch.Tensor      # [B, conv_dim-1, d_inner] trailing inputs


def mamba_init(cfg: ModelConfig, *, generator, device) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    st = cfg.ssm_state_dim
    dt_rank = max(1, d // 16)
    dt = cfg.torch_dtype

    def init(shape):
        return dense_init(shape, dt, generator=generator, device=device)
    return {
        # separate x/z projections (clean column sharding)
        "in_x": init((d, di)),
        "in_z": init((d, di)),
        "conv_w": init((cfg.ssm_conv_dim, di)),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": init((di, dt_rank + 2 * st)),
        "dt_proj": init((dt_rank, di)),
        "dt_bias": torch.full((di,), -4.6, dtype=dt, device=device),
        "A_log": torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                        device=device).expand(di, st)
                           .contiguous()),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": init((di, d)),
    }


def _assoc_scan(a, b):
    """Inclusive scan of h_t = a_t*h_{t-1} + b_t along dim 1, as pairs
    (a_cum, b_cum) combined by (a1, b1)∘(a2, b2) = (a1*a2, a2*b1 + b2):
    log2(n) doubling steps (an associative scan, as the reference's)."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        off *= 2
    return a, b


def _scan_per_rank(scan, args: tuple, like: tuple, roles: tuple):
    """`scan(*args)`, under a mesh in a `shard_map_compat` region where
    each rank scans its own sequences and channels (heads): a scan's
    steps are batch- and channel-parallel, and its many small steps are
    far cheaper on local tensors than as DTensor ops. `like` = (a tensor,
    its channel dim) picks the axes (`pspec.region_axes`); `roles` gives
    each argument's dims as "b" (batch), "c" (channel) or None. The two
    outputs are laid out as the first and the last argument.

    Where the channels do not divide `model` and the batch leaves it
    free, the ranks along `model` would each scan the whole batch shard.
    They split its (sequence, channel) pairs instead, which are
    independent scans, and gather the results back over `model`."""
    if not pspec.is_dtensor(like[0]):
        return scan(*args)
    mesh = like[0].device_mesh
    b_ax, c_ax = pspec.region_axes(*like)
    axes = {"b": b_ax, "c": c_ax}
    specs = tuple(P(*(axes.get(r) for r in role)) for role in roles)
    body = scan
    sizes = pspec.mesh_axes(mesh)
    b_axes = b_ax if isinstance(b_ax, tuple) else (b_ax,) if b_ax else ()
    n = sizes.get("model", 1)
    pairs = (like[0].shape[0] // math.prod(sizes[a] for a in b_axes)
             * like[0].shape[like[1]])
    if c_ax is None and n > 1 and "model" not in b_axes and pairs % n == 0:
        m = list(mesh.mesh_dim_names).index("model")
        body = functools.partial(_scan_pairs, scan, roles, mesh.get_group(m),
                                 n, m, mesh)

    @shard_map_compat(mesh=mesh, in_specs=specs,
                      out_specs=(specs[0], specs[-1]))
    def run(*local):
        return body(*local)

    return run(*args)


def _to_pairs(t, role, bsz: int):
    """[.., B, .., C, ..] laid out as `role` -> [B*C, the other dims]; an
    argument without a batch dim is broadcast over `bsz` first."""
    if "b" not in role:
        t = t.unsqueeze(0).expand(bsz, *t.shape)
        role = ("b",) + tuple(role)
    return t.movedim((role.index("b"), role.index("c")), (0, 1)).flatten(0, 1)


def _from_pairs(t, role, bsz: int):
    """The inverse of `_to_pairs`; an argument without a batch dim takes
    its pairs as its channels."""
    if "b" not in role:
        return t.movedim(0, role.index("c"))
    return t.unflatten(0, (bsz, -1)).movedim(
        (0, 1), (role.index("b"), role.index("c")))


def _scan_pairs(scan, roles, group, n: int, m: int, mesh, *local):
    """`scan` on this rank's 1/n of the (batch, channel) pairs of whole
    local tensors (batch 1, the pairs as channels), the outputs gathered
    over `group` (the `model` ranks, n of them; this one is coordinate m
    of `mesh`)."""
    bsz = next(t.shape[r.index("b")] for t, r in zip(local, roles)
               if "b" in r)
    idx = mesh.get_coordinate()[m]
    part = []
    for t, role in zip(local, roles):
        rows = _to_pairs(t, role, bsz)
        per = rows.shape[0] // n
        part.append(_from_pairs(
            _TakeRows.apply(rows, idx * per, per, group), role, 1))
    outs = scan(*part)
    return tuple(_from_pairs(_GatherRows.apply(_to_pairs(o, r, 1), idx, group),
                             r, bsz)
                 for o, r in zip(outs, (roles[0], roles[-1])))


class _TakeRows(torch.autograd.Function):
    """Rows [lo, lo + n) of a tensor whole on every rank of `group`; the
    gradient, this rank's rows only, is gathered from the group's ranks
    (whole again, the same on each)."""

    @staticmethod
    def forward(ctx, x, lo: int, n: int, group):
        ctx.group = group
        return x.narrow(0, lo, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_rows(grad, ctx.group), None, None, None


class _GatherRows(torch.autograd.Function):
    """Each rank's rows gathered over `group` in rank order, whole on
    every rank; the gradient (the same on each rank) is this rank's
    rows of it."""

    @staticmethod
    def forward(ctx, x, idx: int, group):
        ctx.idx, ctx.n = idx, x.shape[0]
        return _all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(0, ctx.idx * ctx.n, ctx.n).contiguous(), None, None


def _all_gather_rows(x, group):
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor       # the name before torch 2.13
    out = gather(x.contiguous(), 0, group)
    return (out.wait() if isinstance(out, funcol.AsyncCollectiveTensor)
            else out)


def _mamba_scan_chunked(dA, dBx, h0, chunk: int = 256):
    """h_t = dA_t * h_{t-1} + dBx_t over time, chunked associative scan.

    dA, dBx: [B, S, di, st] (f32). Returns (ys [B,S,di,st], h_last).
    """
    b, s, di, st = dA.shape
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:  # pad with identity transitions
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad), value=1.0)
        dBx = F.pad(dBx, (0, 0, 0, 0, 0, pad))
    h = h0
    ys = []
    for c in range(n):
        a_cum, b_cum = _assoc_scan(dA[:, c * chunk:(c + 1) * chunk],
                                   dBx[:, c * chunk:(c + 1) * chunk])
        hs = a_cum * h[:, None] + b_cum          # [B, chunk, di, st]
        h = hs[:, -1]
        ys.append(hs)
    return torch.cat(ys, dim=1)[:, :s], h


def mamba_apply(params, cfg: ModelConfig, x: torch.Tensor,
                state: MambaState | None = None):
    """x: [B, S, d] -> ([B, S, d], state).

    state is None for train (zero init, state discarded); for decode the
    conv/ssm states are carried, updated in place.
    """
    b, s, d = x.shape
    st = cfg.ssm_state_dim
    cd = cfg.ssm_conv_dim
    dt_rank = max(1, d // 16)

    xin = x @ params["in_x"]                               # [B, S, di]
    z = x @ params["in_z"]

    # Causal depthwise conv along seq (per channel: a rank's own channels
    # under a mesh, where torch 2.11's DTensor mis-shards the pad)
    conv = (xin[:, :0] if state is None
            else state.conv.to(xin.dtype))               # [B, cd-1|0, di]
    if pspec.is_dtensor(xin):
        b_ax, c_ax = pspec.region_axes(xin, 2)
        rows = P(b_ax, None, c_ax)
        conv_run = shard_map_compat(
            mesh=xin.device_mesh, in_specs=(rows, rows, P(None, c_ax),
                                            P(c_ax)),
            out_specs=(rows, rows))(_causal_conv)
    else:
        conv_run = _causal_conv
    xc, xpad = conv_run(xin, conv, params["conv_w"], params["conv_b"])

    # x_proj contracts the (model-sharded) channels: its partial sum is
    # reduced before the split (torch 2.11's DTensor cannot split it)
    proj = pspec.reduce_partial(xc @ params["x_proj"])
    dt_in, Bc, Cc = torch.split(proj, [dt_rank, st, st], dim=-1)
    dt = F.softplus(dt_in @ params["dt_proj"]
                    + params["dt_bias"]).float()           # [B,S,di]
    A = -torch.exp(params["A_log"])                        # [di, st]
    dA = torch.exp(dt[..., None] * A)                      # [B,S,di,st]
    dBx = (dt * xc.float())[..., None] \
        * Bc.float()[:, :, None, :]                        # [B,S,di,st]

    h0 = (torch.zeros((b, dt.shape[-1], st), dtype=torch.float32,
                      device=x.device) if state is None else state.h.float())
    if s == 1:
        h_last = dA[:, 0] * h0 + dBx[:, 0]
        hs = h_last[:, None]
    else:
        hs, h_last = _scan_per_rank(
            _mamba_scan_chunked, (dA, dBx, h0), (dA, 2),
            (("b", None, "c", None),) * 2 + (("b", "c", None),))

    y = torch.einsum("bsdn,bsn->bsd", hs, Cc.float())
    y = y + params["D"] * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params["out_proj"]

    if state is not None:
        state.h.copy_(h_last)
        state.conv.copy_(xpad[:, -(cd - 1):])
    return out, state


def _causal_conv(xin, conv, conv_w, conv_b):
    """silu(depthwise causal conv) of xin [B, S, di] after the trailing
    inputs `conv` [B, cd-1, di] (empty: zero padding); returns (xc, the
    padded input [B, cd-1+S, di])."""
    s, cd = xin.shape[1], conv_w.shape[0]
    xpad = (F.pad(xin, (0, 0, cd - 1, 0)) if conv.shape[1] == 0
            else torch.cat([conv, xin], dim=1))
    idx = (torch.arange(s, device=xin.device)[:, None]
           + torch.arange(cd, device=xin.device)[None, :])
    windows = xpad[:, idx]                                 # [B, S, cd, di]
    xc = torch.einsum("bscd,cd->bsd", windows, conv_w) + conv_b
    return F.silu(xc), xpad


def mamba_zero_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None):
    di = cfg.ssm_expand * cfg.d_model
    return MambaState(
        h=torch.zeros((batch, di, cfg.ssm_state_dim), dtype=dtype,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_dim - 1, di), dtype=dtype,
                         device=device))


# ---------------------------------------------------------------------------
# RWKV-6 "Finch": data-dependent decay linear attention
# ---------------------------------------------------------------------------

class RWKVState(NamedTuple):
    wkv: torch.Tensor       # [B, H, dh, dh]
    shift_t: torch.Tensor   # [B, d] last token (time mix)
    shift_c: torch.Tensor   # [B, d] last token (channel mix)


def rwkv_init(cfg: ModelConfig, *, generator, device) -> dict:
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    nh = d // dh
    lora = 64
    dt = cfg.torch_dtype

    def init(shape, dtype=dt, scale=None):
        return dense_init(shape, dtype, generator=generator, device=device,
                          scale=scale)
    return {
        # time-mix lerp coefficients (static part of rwkv6 ddlerp)
        "mu": {k: init((1, 1, d), scale=0.2)
               for k in ["r", "k", "v", "w", "g"]},
        "w_r": init((d, d)),
        "w_k": init((d, d)),
        "w_v": init((d, d)),
        "w_g": init((d, d)),
        "w_o": init((d, d)),
        # data-dependent decay lora: w = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((d,), -2.0, dtype=torch.float32, device=device),
        "w_lora_a": init((d, lora)),
        "w_lora_b": init((lora, d)),
        "u": init((nh, dh), torch.float32),
        "ln_x": torch.ones((d,), dtype=torch.float32, device=device),
    }


def _rwkv_steps(r, k, v, w, u, S0):
    """The WKV recurrence a token at a time (decode). r/k/v/w: [B, S, H,
    dh] -> (y [B, S, H, dh], S_last [B, H, dh, dh])."""
    S_c = S0
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]        # [B,H,dh,dh]
        outs.append(torch.einsum("bhi,bhij->bhj", r_t,
                                 S_c + u[..., None] * kv))
        S_c = w_t[..., :, None] * S_c + kv
    return torch.stack(outs, dim=1), S_c


def _rwkv_chunked_scan(r, k, v, w, u, S0, chunk: int = 64):
    """Chunk-parallel RWKV6 WKV. r/k/v/w: [B, S, H, dh] (w = decay in (0,1)).

    Returns (y [B, S, H, dh], S_last [B, H, dh, dh]). The reference's
    arithmetic as it stands: within-chunk cumulative decays W, k divided by
    max(W, 1e-20), padding with identity decays. Everything but the state
    recurrence is batched over the chunks; the loop over chunks carries the
    state alone, and each chunk's read of its incoming state is one batched
    product after it (the reference's scan body, scheduled so).
    """
    b, s, nh, dh = r.shape
    c = min(chunk, s)
    n = -(-s // c)
    pad = n * c - s
    if pad:  # identity decays, zero k/v contributions
        zp = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, zp), F.pad(k, zp), F.pad(v, zp)
        w = F.pad(w, zp, value=1.0)
    r, k, v, w = (t.reshape(b, n, c, nh, dh) for t in (r, k, v, w))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    W = torch.cumprod(w, dim=2)                           # [B,n,C,H,dh] W_t
    W_prev = W / w                                        # W_{t-1} (W_0 = 1)
    rW = r * W_prev
    kW = k / torch.clamp_min(W, 1e-20)                    # k_s / W_s
    # intra-chunk attention-like matrix [B,n,H,C,C]
    A = torch.einsum("bnthi,bnshi->bnhts", rW, kW)
    A = torch.where(tri, A, 0.0)
    diag = torch.einsum("bnthi,bnthi->bnth", r * u, k)
    intra = torch.einsum("bnhts,bnshj->bnthj", A, v) + diag[..., None] * v
    W_C = W[:, :, -1]                                     # [B,n,H,dh]
    kv = torch.einsum("bnshi,bnshj->bnhij", kW * W_C[:, :, None], v)
    S_c = S0
    states = []                                           # S entering chunk i
    for i in range(n):
        states.append(S_c)
        S_c = W_C[:, i, :, :, None] * S_c + kv[:, i]
    out = intra + torch.einsum("bnthi,bnhij->bnthj", rW,
                               torch.stack(states, dim=1))  # h0 contribution
    y = out.reshape(b, n * c, nh, dh)[:, :s]
    return y, S_c


def rwkv_time_mix(params, cfg: ModelConfig, x: torch.Tensor,
                  state: RWKVState | None = None):
    """RWKV-6 time mixing. x: [B, S, d] -> ([B, S, d], (wkv, shift))."""
    b, s, d = x.shape
    dh = cfg.rwkv_head_dim
    nh = d // dh

    # the carried shift in the activations' layout (the state keeps its
    # channels over `model`; left so, the shift would take x with it)
    prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
            if state is None else
            pspec.constrain_activation(state.shift_t[:, None].to(x.dtype)))
    xs = torch.cat([prev, x[:, :-1]], dim=1)              # token shift
    mu = params["mu"]
    dx = xs - x

    def mix(m):
        return x + dx * mu[m]
    r = split_heads(mix("r") @ params["w_r"], nh, dh)
    k = split_heads(mix("k") @ params["w_k"], nh, dh)
    v = split_heads(mix("v") @ params["w_v"], nh, dh)
    g = F.silu(mix("g") @ params["w_g"])
    wdd = pspec.constrain_channels(
        params["w0"] + torch.tanh(mix("w") @ params["w_lora_a"])
        @ params["w_lora_b"])
    u = params["u"]                                       # [H, dh]

    S0 = (torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=x.device)
          if state is None else state.wkv.float())
    # Chunked WKV for a sequence: O(S/C) sequential chunk steps of matrix
    # products instead of S outer-product steps (see _rwkv_chunked_scan)
    y, S_last = _scan_per_rank(
        functools.partial(_wkv_heads,
                          _rwkv_chunked_scan if s > 1 else _rwkv_steps),
        (r, k, v, split_heads(wdd, nh, dh), u, S0),
        (r, 2), (("b", None, "c", None),) * 4 + (("c", None),
                                                ("b", "c", None, None)))
    # then the gate
    y = (pspec.reshape(y, (b, s, d)) * params["ln_x"]).to(x.dtype) * g
    out = y @ params["w_o"]
    return out, (S_last, x[:, -1])


def _wkv_heads(scan, r, k, v, wdd, u, S0):
    """The WKV of the heads given, in f32, from the decay's logits `wdd`,
    then each head's group norm (ln_x's, before its weight): all per
    head, so under a mesh each rank computes them on its own heads."""
    w = torch.exp(-torch.exp(wdd.float()))                # decay in (0,1)
    y, S_last = scan(r.float(), k.float(), v.float(), w, u, S0)
    y = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
        y.var(-1, keepdim=True, unbiased=False) + 64e-5)
    return y, S_last


def rwkv_channel_mix_init(cfg: ModelConfig, *, generator, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype

    def init(shape, scale=None):
        return dense_init(shape, dt, generator=generator, device=device,
                          scale=scale)
    return {"mu_k": init((1, 1, d), scale=0.2),
            "mu_r": init((1, 1, d), scale=0.2),
            "cm_k": init((d, f)),
            "cm_v": init((f, d)),
            "cm_r": init((d, d))}


def rwkv_channel_mix(params, x: torch.Tensor,
                     shift: torch.Tensor | None = None):
    b, s, d = x.shape
    prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
            if shift is None else
            pspec.constrain_activation(shift[:, None].to(x.dtype)))
    xs = torch.cat([prev, x[:, :-1]], dim=1)
    dx = xs - x
    xk = x + dx * params["mu_k"]
    xr = x + dx * params["mu_r"]
    v = torch.square(torch.relu(xk @ params["cm_k"])) @ params["cm_v"]
    return torch.sigmoid(xr @ params["cm_r"]) * v, x[:, -1]


def rwkv_zero_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None):
    d = cfg.d_model
    nh = d // cfg.rwkv_head_dim
    dh = cfg.rwkv_head_dim
    return RWKVState(
        wkv=torch.zeros((batch, nh, dh, dh), dtype=dtype, device=device),
        shift_t=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_c=torch.zeros((batch, d), dtype=dtype, device=device))
