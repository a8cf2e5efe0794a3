"""Unified decoder-only LM covering dense / MoE / SSM / hybrid / VLM archs.

The layer stack is described by a repeating *pattern* of LayerSpecs derived
from the ModelConfig (gemma3: 5 local + 1 global; jamba: 1 attn + 7 mamba with
alternating MoE; deepseek: leading dense layer then MLA+MoE; ...). The JAX
package scans full pattern repeats over group-stacked parameters; here the
stack is one flat `nn.ModuleList` in plan order (prefix, the groups' layers,
suffix), and the cache is one list in the same order.

Modality frontends are stubs: qwen2-vl consumes a precomputed patch-embedding
prefix; whisper (encdec.py) consumes precomputed audio frame embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import pspec
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (KVCache, MLACache, gqa_apply,
                                          gqa_init, mla_apply, mla_init)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, dense_init, ffn_apply,
                                       ffn_init, rms_norm)
from repro_torch.models.moe import MoEContext, moe_ffn_local, moe_init
from repro_torch.models.pspec import P, mesh_axes
from repro_torch.utils import resolve_device, shard_map_compat


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str   # attn | attn_local | mla | mamba | rwkv
    ffn: str     # dense | moe | channel_mix


@dataclasses.dataclass(frozen=True)
class StackPlan:
    prefix: tuple[LayerSpec, ...]
    pattern: tuple[LayerSpec, ...]
    num_groups: int
    suffix: tuple[LayerSpec, ...]

    @property
    def num_layers(self) -> int:
        return (len(self.prefix) + self.num_groups * len(self.pattern)
                + len(self.suffix))

    def layers(self) -> list[LayerSpec]:
        """Every layer's spec in plan order."""
        return (list(self.prefix) + list(self.pattern) * self.num_groups
                + list(self.suffix))


def build_plan(cfg: ModelConfig) -> StackPlan:
    L = cfg.num_layers
    if cfg.ssm_type == "rwkv6":
        spec = LayerSpec("rwkv", "channel_mix")
        return StackPlan((), (spec,), L, ())
    if cfg.family == "hybrid":  # jamba: attn at pos 0, mamba at 1..p-1
        p = cfg.attn_layer_period
        pattern = []
        for j in range(p):
            mixer = "attn" if j == 0 else "mamba"
            ffn = "moe" if (cfg.moe_num_experts and j % cfg.moe_layer_period
                            == cfg.moe_layer_period - 1) else "dense"
            pattern.append(LayerSpec(mixer, ffn))
        if L % p:
            raise ValueError(f"{cfg.name}: layers {L} % period {p} != 0")
        return StackPlan((), tuple(pattern), L // p, ())
    mixer = "mla" if cfg.attn_type == "mla" else "attn"
    ffn = "moe" if cfg.moe_num_experts else "dense"
    prefix = tuple(LayerSpec(mixer, "dense")
                   for _ in range(cfg.moe_first_dense))
    rest = L - len(prefix)
    if cfg.local_global_period:  # gemma3: 5 local + 1 global
        p = cfg.local_global_period
        pattern = tuple(LayerSpec("attn_local" if j < p - 1 else "attn", ffn)
                        for j in range(p))
        groups, rem = divmod(rest, p)
        suffix = pattern[:rem]
        return StackPlan(prefix, pattern, groups, suffix)
    return StackPlan(prefix, (LayerSpec(mixer, ffn),), rest, ())


# ---------------------------------------------------------------------------
# Per-layer init/apply
# ---------------------------------------------------------------------------

def _layer_init(cfg: ModelConfig, spec: LayerSpec, *, generator,
                device) -> dict:
    kw = {"generator": generator, "device": device}
    p: dict[str, Any] = {
        "norm1": torch.zeros((cfg.d_model,), dtype=torch.float32,
                             device=device),
        "norm2": torch.zeros((cfg.d_model,), dtype=torch.float32,
                             device=device)}
    if spec.mixer in ("attn", "attn_local"):
        p["mixer"] = gqa_init(cfg, **kw)
    elif spec.mixer == "mla":
        p["mixer"] = mla_init(cfg, **kw)
    elif spec.mixer == "mamba":
        p["mixer"] = ssm_lib.mamba_init(cfg, **kw)
    elif spec.mixer == "rwkv":
        p["mixer"] = ssm_lib.rwkv_init(cfg, **kw)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn == "dense":
        p["ffn"] = ffn_init(cfg.d_model, cfg.d_ff, cfg.ffn_act,
                            cfg.torch_dtype, **kw)
    elif spec.ffn == "moe":
        p["ffn"] = moe_init(cfg, **kw)
    elif spec.ffn == "channel_mix":
        p["ffn"] = ssm_lib.rwkv_channel_mix_init(cfg, **kw)
    else:
        raise ValueError(spec.ffn)
    return p


def _layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, s_max: int,
                 dtype, device) -> Any:
    if spec.mixer in ("attn", "attn_local"):
        # attn_local keeps a full-length cache, not a window-sized ring,
        # so positions stay plain (a ring would halve local-layer caches)
        shape = (batch, s_max, cfg.num_kv_heads, cfg.hd)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))
    if spec.mixer == "mla":
        return MLACache(
            ckv=torch.zeros((batch, s_max, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
            krope=torch.zeros((batch, s_max, cfg.qk_rope_dim), dtype=dtype,
                              device=device))
    if spec.mixer == "mamba":
        return ssm_lib.mamba_zero_state(cfg, batch, device=device)
    if spec.mixer == "rwkv":
        return ssm_lib.rwkv_zero_state(cfg, batch, device=device)
    raise ValueError(spec.mixer)


def _layer_apply(params, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                 *, positions, cache=None, cache_pos=None, mesh=None):
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if spec.mixer in ("attn", "attn_local"):
        window = cfg.sliding_window if spec.mixer == "attn_local" else 0
        out, _ = gqa_apply(params["mixer"], cfg, h, positions=positions,
                           window=window, cache=cache, cache_pos=cache_pos)
    elif spec.mixer == "mla":
        out, _ = mla_apply(params["mixer"], cfg, h, positions=positions,
                           cache=cache, cache_pos=cache_pos)
    elif spec.mixer == "mamba":
        out, _ = ssm_lib.mamba_apply(params["mixer"], cfg, h, state=cache)
    elif spec.mixer == "rwkv":
        out, (wkv, shift) = ssm_lib.rwkv_time_mix(params["mixer"], cfg, h,
                                                  state=cache)
        if cache is not None:
            cache.wkv.copy_(wkv)
            cache.shift_t.copy_(shift)
    else:
        raise ValueError(spec.mixer)
    x = pspec.constrain_activation(x + out)

    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    if spec.ffn == "dense":
        f = ffn_apply(params["ffn"], h, cfg.ffn_act)
    elif spec.ffn == "moe":
        b, s, d = h.shape
        f = _moe_apply(params["ffn"], cfg, h.reshape(b * s, d), mesh)
        f = f.reshape(b, s, d)
    elif spec.ffn == "channel_mix":
        shift_c = cache.shift_c if cache is not None else None
        f, new_shift = ssm_lib.rwkv_channel_mix(params["ffn"], h, shift_c)
        if cache is not None:
            cache.shift_c.copy_(new_shift)
    else:
        raise ValueError(spec.ffn)
    return pspec.constrain_activation(x + f), cache


def _token_spec(t: int, mesh):
    """Best divisible token sharding for the MoE local region."""
    shape = mesh_axes(mesh)
    chosen: list[str] = []
    size = 1
    for a in ("pod", "data", "model"):
        if a in shape and t % (size * shape[a]) == 0:
            chosen.append(a)
            size *= shape[a]
    return tuple(chosen) if chosen else None


def _moe_apply(params, cfg, x2d, mesh):
    """The MoE FFN: the local dispatch without a mesh; with one, the
    expert-parallel all-to-all inside a `shard_map_compat` region over
    the `model` axis, tokens split over every axis that divides them
    (capacity is then counted per rank, as under JAX's shard_map).

    Unlike JAX, where GSPMD runs the dispatch for a mesh whose `model`
    axis is 1, the dispatch's sort, cumsum and accumulating scatter have
    no DTensor sharding rule: on such a mesh the region runs with
    ep_size 1 on the tokens split over the other axes, which counts
    capacity per rank too (equal to JAX's on one device)."""
    tree = {k: params[k] for k in ("router", "wi", "wg", "wo")}
    if "shared" in params:
        tree["shared"] = {k: params["shared"][k]
                          for k in ("wi", "wg", "wo")}
    if mesh is None:
        return moe_ffn_local(tree, cfg, x2d, None)
    shape = mesh_axes(mesh)
    ep = shape.get("model", 1)
    tok_axes = _token_spec(x2d.shape[0], mesh)
    ctx = MoEContext(ep_axis="model", ep_size=ep, mesh=mesh)
    e_ax = "model" if ep > 1 else None

    @shard_map_compat(mesh=mesh,
                      in_specs=({"router": P(), "wi": P(e_ax),
                                 "wg": P(e_ax), "wo": P(e_ax),
                                 **({"shared": P()} if "shared" in tree
                                    else {})},
                                P(tok_axes)),
                      out_specs=P(tok_axes))
    def run(p, x):
        return moe_ffn_local(p, cfg, x, ctx)

    out = run(tree, x2d)
    if pspec.is_dtensor(x2d):
        from torch.distributed.tensor import Replicate
        # back to the tokens' own layout before the caller's [B, S, d]
        # view: a split over every axis need not fall on whole sequences
        # (prefill's 32 sequences over 256 ranks), which a DTensor view
        # cannot express
        out = out.redistribute(x2d.device_mesh, [
            Replicate() if p.is_partial() else p for p in x2d.placements])
    return out


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """`TransformerLM(cfg, device=..., seed=...)` makes random weights on
    `device` from a `torch.Generator`, layer by layer (the peak stays near
    the model's own bytes); `repro_torch.convert.load_reference_params`
    loads the JAX package's weights instead. `device="meta"` builds the
    shapes alone. Parameters: `embed`, `final_norm`, `lm_head` (untied),
    `layers.{i}.*` in plan order."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.specs = self.plan.layers()
        device = resolve_device(device)
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        kw = {"generator": gen, "device": device}
        dt = cfg.torch_dtype
        self.embed = nn.Parameter(dense_init(
            (cfg.vocab_size, cfg.d_model), dt, scale=1.0, **kw))
        self.final_norm = nn.Parameter(torch.zeros(
            (cfg.d_model,), dtype=torch.float32, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(
                (cfg.d_model, cfg.vocab_size), dt, **kw))
        self.layers = nn.ModuleList(
            Params(_layer_init(cfg, spec, **kw)) for spec in self.specs)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, batch: int, s_max: int, dtype=None) -> list:
        """One cache a layer in plan order: KVCache / MLACache in `dtype`
        (default the config's), MambaState / RWKVState in f32."""
        dtype = dtype or self.cfg.torch_dtype
        return [_layer_cache(self.cfg, spec, batch, s_max, dtype,
                             self.device) for spec in self.specs]

    # -- forward -----------------------------------------------------------
    def _embed(self, tokens, vision_embeds=None):
        # F.embedding, not indexing: DTensor shards a gather through its
        # embedding rule. A vocab-sharded table gives a masked partial
        # sum, reduced here at the gather's own shape (its mask does not
        # follow a later slice)
        x = pspec.reduce_partial(F.embedding(
            tokens, pspec.gather_table(self.embed)))
        if vision_embeds is not None:
            nv = vision_embeds.shape[1]
            x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
        # sqrt(d_model) in f32, rounded to the activation dtype (a host
        # number: no copy to the card)
        scale = torch.tensor(float(np.sqrt(np.float32(self.cfg.d_model))),
                             dtype=torch.float32).to(x.dtype)
        # the block boundary's layout from the first block on: a table
        # sharded on d would hand the first norm a d-sharded input, whose
        # partial statistics DTensor reduce-scatters over the sequence
        return pspec.constrain_activation(x * float(scale))

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _unembed(self, x):
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self._head()

    def _run_stack(self, x, *, positions, cache=None, cache_pos=None,
                   mesh=None, remat: bool = False):
        """The layers in plan order. `remat` recomputes each pattern group
        (the groups' layers, `len(plan.pattern)` at a time; not the prefix
        or suffix) in the backward pass from its saved input
        (`torch.utils.checkpoint`, not reentrant), as the JAX package's
        `jax.checkpoint` of its scan body."""
        def run(lo: int, hi: int, x):
            for i in range(lo, hi):
                x, _ = _layer_apply(
                    self.layers[i], self.cfg, self.specs[i], x,
                    positions=positions,
                    cache=None if cache is None else cache[i],
                    cache_pos=cache_pos, mesh=mesh)
            return x

        if not remat or cache is not None:
            return run(0, len(self.specs), x)
        lo, period = len(self.plan.prefix), len(self.plan.pattern)
        hi = lo + self.plan.num_groups * period
        x = run(0, lo, x)
        for g in range(lo, hi, period):
            x = checkpoint(run, g, g + period, x, use_reentrant=False)
        return run(hi, len(self.specs), x)

    def _positions(self, start: int, s: int) -> torch.Tensor:
        return torch.arange(start, start + s, device=self.device)

    def forward(self, tokens, *, vision_embeds=None, mesh=None,
                remat: bool = False):
        """Teacher-forced logits. tokens: [B, S] -> [B, S, V]. With a
        mesh, the parameters and inputs are DTensors on it."""
        with pspec.spmd(mesh):
            x = self._embed(tokens, vision_embeds)
            x = self._run_stack(x, positions=self._positions(
                0, tokens.shape[1]), mesh=mesh, remat=remat)
            return self._unembed(x)

    def loss(self, tokens, labels, *, vision_embeds=None, mesh=None,
             remat: bool = False, vocab_chunk: int = 0):
        """Mean next-token cross-entropy; optional seq-chunked unembed."""
        with pspec.spmd(mesh):
            return self._loss(tokens, labels, vision_embeds, mesh, remat,
                              vocab_chunk)

    def _loss(self, tokens, labels, vision_embeds, mesh, remat, vocab_chunk):
        s = tokens.shape[1]
        x = self._embed(tokens, vision_embeds)
        x = self._run_stack(x, positions=self._positions(0, s), mesh=mesh,
                            remat=remat)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self._head()

        # Vocab-parallel loss: activations replicated over `model`, the
        # unembed weight vocab-sharded over `model`; each shard computes
        # the logits of its vocab slice, and only [tokens] statistics
        # cross shards (the hints act under an active mesh, as in JAX).
        vp = None
        axes = mesh_axes(mesh) if mesh is not None else {}
        if "model" in axes and self.cfg.vocab_size % axes["model"] == 0:
            vp = axes["model"]
            w = pspec.constrain(w, P(None, "model"))

        def xent(h, y):
            if vp is not None:
                dp = (pspec.batch_axes(mesh, h.shape[0])
                      if pspec.parallel_mode() != "fsdp_only" else
                      tuple(a for a in ("pod", "data") if a in axes) or None)
                h = pspec.constrain(h, P(dp, None, None))
            logits = (h @ w).float()
            logz = torch.logsumexp(logits, dim=-1)
            # the gold logit as h · w[:, y] in h's dtype (the logit's own
            # rounding), not a gather from the logits: a gather's backward
            # makes a zero tensor of the logits' GLOBAL shape on every rank
            # under DTensor. The columns come through the embedding rule
            # (masked partial sum over vocab shards, reduced here).
            w_y = pspec.reduce_partial(F.embedding(
                y, pspec.gather_table(w.T)))
            gold = torch.einsum("bsd,bsd->bs", h, w_y.to(h.dtype)).float()
            return logz - gold

        if vocab_chunk and s % vocab_chunk == 0 and s > vocab_chunk:
            losses = [xent(x[:, c:c + vocab_chunk],
                           labels[:, c:c + vocab_chunk]).mean()
                      for c in range(0, s, vocab_chunk)]
            return torch.stack(losses).mean()
        return xent(x, labels).mean()

    @torch.no_grad()
    def prefill(self, tokens, cache, *, vision_embeds=None, mesh=None):
        """Fill the cache with a prompt (in place); returns (last-token
        logits [B, 1, V], cache)."""
        with pspec.spmd(mesh):
            x = self._embed(tokens, vision_embeds)
            x = self._run_stack(x, positions=self._positions(
                0, tokens.shape[1]), cache=cache, cache_pos=0, mesh=mesh)
            return self._unembed(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token, cache, cache_pos: int, *, mesh=None):
        """One decode step. token: [B, 1]; cache_pos: the write index."""
        with pspec.spmd(mesh):
            x = self._embed(token)
            x = self._run_stack(x, positions=self._positions(cache_pos, 1),
                                cache=cache, cache_pos=cache_pos, mesh=mesh)
            return self._unembed(x), cache
