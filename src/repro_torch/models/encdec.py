"""Whisper-style encoder-decoder (the audio frontend is a stub: callers pass
precomputed conv-frontend frame embeddings).

Encoder: bidirectional self-attention blocks over [B, S_audio, d] frames.
Decoder: causal self-attention (KV-cached) + cross-attention to the encoder
output (cross-KV computed from it on every call, as the reference does).

Whisper uses absolute positions (no RoPE): learned position embeddings on
both sides.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import pspec
from repro_torch.models.attention import KVCache, gqa_apply, gqa_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, dense_init, ffn_apply,
                                       ffn_init, layer_norm, split_heads)
from repro_torch.utils import resolve_device


class WhisperCache(NamedTuple):
    self_kv: Any      # one KVCache a decoder layer
    cross_kv: Any     # per-decoder-layer (k, v) from the encoder output


def _block_init(cfg: ModelConfig, *, cross: bool, generator, device) -> dict:
    d = cfg.d_model

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=device)

    def zeros():
        return torch.zeros((d,), dtype=torch.float32, device=device)
    kw = {"generator": generator, "device": device}
    p = {"norm1_w": ones(), "norm1_b": zeros(),
         "norm2_w": ones(), "norm2_b": zeros(),
         "attn": gqa_init(cfg, **kw),
         "ffn": ffn_init(d, cfg.d_ff, "gelu", cfg.torch_dtype, **kw)}
    if cross:
        p["norm_x_w"] = ones()
        p["norm_x_b"] = zeros()
        p["xattn"] = gqa_init(cfg, **kw)
    return p


class WhisperModel(nn.Module):
    """cfg.num_layers encoder + cfg.num_decoder_layers decoder blocks.
    Parameters: `enc_pos`, `dec_embed`, `dec_pos`, `enc.{i}.*`,
    `dec.{i}.*`, the final norms; random from a `torch.Generator` on
    `device` (`device="meta"`: shapes only)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.enc_layers = cfg.num_layers
        self.dec_layers = cfg.num_decoder_layers or cfg.num_layers
        device = resolve_device(device)
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        kw = {"generator": gen, "device": device}
        dt, d = cfg.torch_dtype, cfg.d_model
        # the tables keep the reference's shapes (param_count compares them)
        self.enc_pos = nn.Parameter(dense_init(
            (cfg.encoder_seq_len * 32, d), dt, scale=0.02, **kw))
        self.dec_embed = nn.Parameter(dense_init(
            (cfg.vocab_size, d), dt, scale=1.0, **kw))
        self.dec_pos = nn.Parameter(dense_init(
            (cfg.decoder_text_len * 128, d), dt, scale=0.02, **kw))
        self.enc = nn.ModuleList(Params(_block_init(cfg, cross=False, **kw))
                                 for _ in range(self.enc_layers))
        self.dec = nn.ModuleList(Params(_block_init(cfg, cross=True, **kw))
                                 for _ in range(self.dec_layers))
        for side in ("enc", "dec"):
            self.register_parameter(f"{side}_norm_w", nn.Parameter(
                torch.ones((d,), dtype=torch.float32, device=device)))
            self.register_parameter(f"{side}_norm_b", nn.Parameter(
                torch.zeros((d,), dtype=torch.float32, device=device)))

    @property
    def device(self) -> torch.device:
        return self.dec_embed.device

    # -- encoder -----------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, S_audio, d_model] stub embeddings -> encoder states."""
        cfg = self.cfg
        s = frames.shape[1]
        # the positions whole (a table sharded on d would take the frames'
        # batch shard with it: torch 2.11 shards their sum on d over every
        # mesh dim), then the batch over the policy's axes
        x = pspec.constrain_activation(
            frames.to(cfg.torch_dtype) + pspec.replicate(self.enc_pos[:s]))
        positions = torch.arange(s, device=x.device)
        for lp in self.enc:
            h = layer_norm(x, lp["norm1_w"], lp["norm1_b"])
            out, _ = gqa_apply(lp["attn"], cfg, h, positions=positions,
                               causal=False, use_rope=False)
            x = x + out
            h = layer_norm(x, lp["norm2_w"], lp["norm2_b"])
            x = x + ffn_apply(lp["ffn"], h, "gelu")
        return layer_norm(x, self.enc_norm_w, self.enc_norm_b)

    # -- decoder -----------------------------------------------------------
    def _dec_block(self, lp, cfg, x, *, positions, self_cache, cache_pos,
                   cross_kv):
        h = layer_norm(x, lp["norm1_w"], lp["norm1_b"])
        out, new_self = gqa_apply(lp["attn"], cfg, h, positions=positions,
                                  causal=True, use_rope=False,
                                  cache=self_cache, cache_pos=cache_pos)
        x = x + out
        h = layer_norm(x, lp["norm_x_w"], lp["norm_x_b"])
        out, _ = gqa_apply(lp["xattn"], cfg, h, positions=positions,
                           use_rope=False, cross_kv=cross_kv)
        x = x + out
        h = layer_norm(x, lp["norm2_w"], lp["norm2_b"])
        return x + ffn_apply(lp["ffn"], h, "gelu"), new_self

    def _cross_kv(self, enc_out):
        """Per-decoder-layer cross K/V from the encoder output."""
        cfg = self.cfg
        nkv, hd = cfg.num_kv_heads, cfg.hd
        return [(split_heads(enc_out @ lp["xattn"]["wk"], nkv, hd),
                 split_heads(enc_out @ lp["xattn"]["wv"], nkv, hd))
                for lp in self.dec]

    def decode(self, tokens, enc_out, *, cache=None, cache_pos=None):
        """Teacher-forced decode (train) or a cached step.

        tokens: [B, S_text]; enc_out: [B, S_audio, d]; cache_pos: an int.
        """
        cfg = self.cfg
        s = tokens.shape[1]
        # F.embedding, not indexing: DTensor shards a gather through its
        # embedding rule (torch 2.11 has no rule for indexing a table
        # sharded on d by ids sharded on the same mesh dims)
        x = pspec.reduce_partial(F.embedding(
            tokens, pspec.gather_table(self.dec_embed)))
        start = 0 if cache_pos is None else cache_pos
        positions = torch.arange(start, start + s, device=x.device)
        x = pspec.constrain_activation(
            x + pspec.replicate(self.dec_pos[start:start + s]))

        cross = self._cross_kv(enc_out)
        for i, lp in enumerate(self.dec):
            x, _ = self._dec_block(
                lp, cfg, x, positions=positions,
                self_cache=None if cache is None else cache.self_kv[i],
                cache_pos=cache_pos, cross_kv=cross[i])
        new_cache = (None if cache is None
                     else WhisperCache(self_kv=cache.self_kv, cross_kv=None))

        x = layer_norm(x, self.dec_norm_w, self.dec_norm_b)
        logits = x @ self.dec_embed.T  # whisper ties the output embedding
        return logits, new_cache

    def init_cache(self, batch: int, s_max: int, dtype=None):
        cfg = self.cfg
        dtype = dtype or cfg.torch_dtype
        shape = (batch, s_max, cfg.num_kv_heads, cfg.hd)
        return WhisperCache(self_kv=[
            KVCache(k=torch.zeros(shape, dtype=dtype, device=self.device),
                    v=torch.zeros(shape, dtype=dtype, device=self.device))
            for _ in range(self.dec_layers)], cross_kv=None)

    def loss(self, frames, tokens, labels):
        enc = self.encode(frames)
        logits, _ = self.decode(tokens, enc)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = pspec.gather_last(logits, labels)
        return (logz - gold).mean()
