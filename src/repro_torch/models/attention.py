"""Attention variants: GQA (RoPE, optional sliding window) and MLA (DeepSeek).

Prefill/train use a chunked online-softmax attention (a loop over KV chunks)
so a long prefill never materializes an [S, S] score matrix. Decode attends
one query against the KV cache directly. Plain torch ops: no library
attention kernel, so the masks, the chunking and the f32 accumulation are
the JAX package's.

Caches are tensors written in place at `cache_pos` (a Python int,
`pspec.write_at`); each call still returns its cache. The `pspec`
cache constraints stand where the JAX package has them: identities
without an active mesh, redistributions of DTensors under one. Its
decode-score hints have no counterpart: the port's decode scores are
plain tensors inside the per-rank region.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, split_heads
from repro_torch.models.pspec import P
from repro_torch.utils import shard_map_compat

NEG_INF = -1e30   # not -inf: a fully masked chunk must not give NaN


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, KV, hd]
    v: torch.Tensor


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of operands in their own dtype with an f32 result (the
    reference's `preferred_element_type=float32`): a product of two bf16
    values is exact in f32, so widening the operands first is that."""
    return torch.einsum(eq, a.float(), b.float())


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset=0, kv_len=None, chunk: int = 512,
                      seq_groups=(), kv_offset: int = 0, kv_total=None):
    """Online-softmax attention, O(chunk) score memory.

    q: [B, Sq, KV, G, hd_qk]   (G = query heads per KV group)
    k: [B, Skv, KV, hd_qk];  v: [B, Skv, KV, hd_v]
    q_offset: position of q[0], an int or a 0-d tensor on q's device
    window: >0 => only attend to kpos in (qpos-window, qpos]
    kv_len: optional int; kpos >= kv_len masked out (decode w/ cache)
    seq_groups, kv_offset, kv_total: set by the per-rank region of a
      decode step whose cache is sharded along the sequence: this rank's
      keys start at kv_offset of kv_total, and the softmax is combined
      over the process groups in seq_groups
    """
    if pspec.is_dtensor(q):
        return _attention_per_rank(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len,
                                   chunk=chunk)
    b, sq, nkv, g, hd = q.shape
    hd_v = v.shape[-1]
    skv = k.shape[1]
    dev = q.device

    qpos = q_offset + torch.arange(sq, device=dev)           # [Sq]
    # 1/sqrt(hd) rounded as the reference rounds it (f32 throughout); a
    # Python number, so the card gets no host-to-device copy
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qf = q.float() * scale

    if sq == 1:
        # Decode fast path: one query against the whole cache, no chunks
        # (over sequence shards: sequence-parallel flash-decode)
        s = _f32_einsum("bqkgh,bskh->bqkgs", qf.to(k.dtype), k)
        kpos = kv_offset + torch.arange(skv, device=dev)
        mask = kpos < (kv_len if kv_len is not None else kv_total or skv)
        if causal:
            mask &= kpos <= qpos[0]
        if window > 0:
            mask &= kpos > qpos[0] - window
        s = torch.where(mask[None, None, None, None, :], s, NEG_INF)
        if not seq_groups:
            p = torch.softmax(s, dim=-1)
            out = _f32_einsum("bqkgs,bskh->bqkgh", p.to(v.dtype), v)
            return out.to(q.dtype)
        from torch.distributed import _functional_collectives as funcol
        m = s.amax(dim=-1, keepdim=True)
        for group in seq_groups:
            m = funcol.all_reduce(m, "max", group)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out = _f32_einsum("bqkgs,bskh->bqkgh", p.to(v.dtype), v)
        for group in seq_groups:
            l = funcol.all_reduce(l, "sum", group)
            out = funcol.all_reduce(out, "sum", group)
        return (out / l.squeeze(-1)[..., None]).to(q.dtype)

    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    m = torch.full((b, sq, nkv, g, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, sq, nkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, nkv, g, hd_v), dtype=torch.float32, device=dev)
    qk = qf.to(k.dtype)
    for ci in range(n_chunks):
        # a short last chunk stands for the reference's zero padding: its
        # padded keys are masked (kpos < skv), so they add nothing
        k_i = k[:, ci * chunk:(ci + 1) * chunk]
        v_i = v[:, ci * chunk:(ci + 1) * chunk]
        kpos = ci * chunk + torch.arange(k_i.shape[1], device=dev)   # [Ck]
        s = _f32_einsum("bqkgh,bckh->bqkgc", qk, k_i)
        mask = torch.ones((sq, k_i.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _f32_einsum("bqkgc,bckh->bqkgh", p.to(v_i.dtype),
                                       v_i)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def _rows_times(c, w):
    """c [B, S, r] @ w [r, n]. A DTensor `c` sharded on both B and S (a
    batch- and sequence-sharded cache) is one DTensor cannot flatten for
    the product (torch 2.11 refuses the view): each rank multiplies its
    own rows by the whole w (gathered: the up-projections are small)."""
    if not pspec.is_dtensor(c):
        return c @ w
    spec = pspec.spec_of(c)
    if spec[0] is None or spec[1] is None:
        return c @ w
    rows = P(spec[0], spec[1], None)

    @shard_map_compat(mesh=c.device_mesh, in_specs=(rows, P()),
                      out_specs=rows)
    def run(c_l, w_l):
        return c_l @ w_l

    return run(c, w)


def _attention_per_rank(q, k, v, **kw):
    """Attention on DTensors: a `shard_map_compat` region over q's batch
    and KV-head shards, in which each rank attends its own sequences and
    heads (DTensor's propagation through the chunk loop's einsums
    replicates products that divide, and torch 2.11 refuses the decode
    einsum's views). Prefill and train take k and v whole along the
    sequence (a sequence-sharded cache is gathered for them); a decode
    step keeps the cache's sequence shards and combines the softmax
    across them (`chunked_attention`'s `seq_groups`).

    Where `model` takes neither the batch nor the KV heads (they do not
    divide it), a prefill or train step splits the queries along the
    sequence over `model` instead, so its ranks do not all repeat the
    whole attention (GSPMD's split of the same einsums): each rank
    attends its block of queries, offset by the block's start, against
    the whole keys, whose gradient is then a partial sum over `model`."""
    b_ax, kv_ax = pspec.region_axes(q, 2)
    mesh = q.device_mesh
    s_ax = q_ax = None
    if q.shape[1] == 1:
        used = {a for e in (b_ax, kv_ax) if e
                for a in (e if isinstance(e, tuple) else (e,))}
        s_ax = pspec.spec_of(k)[1]
        axes = s_ax if isinstance(s_ax, tuple) else (s_ax,)
        if s_ax is None or used & set(axes):
            s_ax = None
    elif kv_ax is None and "model" not in (
            b_ax if isinstance(b_ax, tuple) else (b_ax,)):
        q_ax = pspec.axis_if(mesh, q.shape[1], ("model",))
    qs = P(b_ax, q_ax, kv_ax, None, None)
    ks = P(b_ax, s_ax, kv_ax, None)
    names = list(mesh.mesh_dim_names)
    s_dims = sorted(names.index(a) for a in (
        () if s_ax is None else s_ax if isinstance(s_ax, tuple) else (s_ax,)))
    q_dim = None if q_ax is None else names.index(q_ax)
    q_offset = kw.pop("q_offset")

    @shard_map_compat(mesh=mesh, in_specs=(qs, ks, ks), out_specs=qs)
    def run(q_l, k_l, v_l):
        coord = mesh.get_coordinate()
        block = 0
        for m in s_dims:
            block = block * mesh.size(m) + coord[m]
        q_block = 0 if q_dim is None else coord[q_dim]
        return chunked_attention(
            q_l, k_l, v_l, seq_groups=[mesh.get_group(m) for m in s_dims],
            kv_offset=block * k_l.shape[1], kv_total=k.shape[1],
            q_offset=q_offset + q_block * q_l.shape[1], **kw)

    out = run(q, k, v)
    if q_ax is None:
        return out
    # the query blocks gathered again, into the layout the heads' path
    # gives (a product over batch and sequence both sharded would hand
    # DTensor strided shards, whose redistributions it plans by search)
    return out.redistribute(mesh, pspec.to_placements(
        P(b_ax, None, kv_ax, None, None), mesh))


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_init(cfg: ModelConfig, *, generator, device,
             kv_heads: Optional[int] = None) -> dict:
    d, hd = cfg.d_model, cfg.hd
    nh = cfg.num_heads
    nkv = kv_heads if kv_heads is not None else cfg.num_kv_heads
    dt = cfg.torch_dtype

    def init(shape):
        return dense_init(shape, dt, generator=generator, device=device)
    return {"wq": init((d, nh * hd)), "wk": init((d, nkv * hd)),
            "wv": init((d, nkv * hd)), "wo": init((nh * hd, d))}


def gqa_apply(params, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, window: int = 0, causal: bool = True,
              cache: Optional[KVCache] = None, cache_pos: Optional[int] = None,
              cross_kv: Optional[tuple] = None, use_rope: bool = True):
    """x: [B, S, d]; positions: [S] int tensor -> ([B, S, d], cache).

    With a cache, k and v are written into it at `cache_pos` in place and
    the returned cache is the same tensors."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.hd
    nkv = params["wk"].shape[1] // hd
    g = nh // nkv

    q = split_heads(x @ params["wq"], nh, hd)
    if cross_kv is None:
        k = split_heads(x @ params["wk"], nkv, hd)
        v = split_heads(x @ params["wv"], nkv, hd)
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = cross_kv
        if k.shape[2] != nkv:  # cross-attn kv heads follow the provided kv
            nkv = k.shape[2]
            g = nh // nkv

    new_cache = None
    kv_len = None
    q_offset = positions[0]
    if cache is not None and cross_kv is None:
        # into the cache's own buffers (a constrained copy would take the
        # write); the constraint pins what the attention reads
        pspec.write_at(cache.k, k, cache_pos)
        pspec.write_at(cache.v, v, cache_pos)
        new_cache = cache
        k, v = pspec.constrain_kv(cache.k), pspec.constrain_kv(cache.v)
        kv_len = cache_pos + s

    qg = pspec.reshape(q, (b, s, nkv, g, hd))
    out = chunked_attention(qg, k, v, causal=causal and cross_kv is None,
                            window=window, q_offset=q_offset, kv_len=kv_len)
    out = pspec.constrain_channels(pspec.reshape(out, (b, s, nh * hd)))
    return out @ params["wo"], new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-KV multi-head latent attention
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    ckv: torch.Tensor    # [B, S_max, kv_lora]
    krope: torch.Tensor  # [B, S_max, qk_rope_dim]


def mla_init(cfg: ModelConfig, *, generator, device) -> dict:
    d = cfg.d_model
    nh = cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    dt = cfg.torch_dtype

    def init(shape):
        return dense_init(shape, dt, generator=generator, device=device)
    return {
        "wq": init((d, nh * qk)),
        "w_dkv": init((d, cfg.kv_lora_rank)),
        "w_kr": init((d, cfg.qk_rope_dim)),
        "k_up": init((cfg.kv_lora_rank, nh * cfg.qk_nope_dim)),
        "v_up": init((cfg.kv_lora_rank, nh * cfg.v_head_dim)),
        "wo": init((nh * cfg.v_head_dim, d)),
    }


def mla_apply(params, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, cache: Optional[MLACache] = None,
              cache_pos: Optional[int] = None):
    b, s, d = x.shape
    nh = cfg.num_heads
    nope, rope_d, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    q = split_heads(x @ params["wq"], nh, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = x @ params["w_dkv"]                                   # [B, S, lora]
    krope = apply_rope((x @ params["w_kr"])[:, :, None, :],
                       positions, cfg.rope_theta)[:, :, 0, :]   # [B, S, rope]

    new_cache = None
    kv_len = None
    q_offset = positions[0]
    if cache is not None:
        pspec.write_at(cache.ckv, ckv, cache_pos)
        pspec.write_at(cache.krope, krope, cache_pos)
        new_cache = cache
        ckv = pspec.constrain_mla(cache.ckv)
        krope = pspec.constrain_mla(cache.krope)
        kv_len = cache_pos + s

    skv = ckv.shape[1]
    # Up-project the compressed cache (the materializing form; the absorbed
    # decode variant is not the reference's)
    k_nope = split_heads(_rows_times(ckv, params["k_up"]), nh, nope)
    v = split_heads(_rows_times(ckv, params["v_up"]), nh, vh)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(b, skv, nh, rope_d)],
                  dim=-1)
    qh = torch.cat([q_nope, q_rope], dim=-1)                    # [B,S,H,qk]

    out = chunked_attention(qh[:, :, :, None, :], k, v, causal=True,
                            q_offset=q_offset, kv_len=kv_len)
    out = pspec.constrain_channels(pspec.reshape(out, (b, s, nh * vh)))
    return out @ params["wo"], new_cache
