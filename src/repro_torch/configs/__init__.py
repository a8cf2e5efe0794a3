"""Config registry: `--arch <id>` resolution + reduced smoke-test variants.

The ten LM architectures (shapes only, copied value for value from the
JAX package's configs with their `source` tags), `dlrm-production`,
MLPerf's `dlrm-dcnv2`, `hstu-ranking` and `hstu-retrieval` (the port's
only: the JAX package has no ragged tables, cross network or HSTU).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

# arch id -> module name
_ARCH_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "rwkv6-7b": "rwkv6_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "minitron-8b": "minitron_8b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "gemma3-27b": "gemma3_27b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-medium": "whisper_medium",
}
LM_ARCHS = tuple(_ARCH_MODULES)
_RECSYS_MODULES = {"dlrm-production": "dlrm_production",
                   "dlrm-dcnv2": "dlrm_dcnv2",
                   "hstu-ranking": "hstu_ranking",
                   "hstu-retrieval": "hstu_retrieval"}
ALL_ARCHS = LM_ARCHS + tuple(_RECSYS_MODULES)


def get_config(arch: str):
    if arch in _RECSYS_MODULES:
        return importlib.import_module(
            f"repro_torch.configs.{_RECSYS_MODULES[arch]}").CONFIG
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ALL_ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}").CONFIG


def reduced(cfg: ModelConfig, *, layers: int | None = None) -> ModelConfig:
    """Family-preserving shrink for CPU smoke tests: small widths, few
    experts, tiny vocab — same block pattern and code paths."""
    plan_period = 1
    if cfg.family == "hybrid":
        plan_period = cfg.attn_layer_period
    elif cfg.local_global_period:
        plan_period = cfg.local_global_period
    n_layers = layers or max(2 * plan_period, 2)
    if cfg.local_global_period:
        n_layers = cfg.local_global_period + 2  # one full group + suffix
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads
        < cfg.num_heads else 4,
        head_dim=32 if cfg.head_dim else 0,
        d_ff=256,
        vocab_size=512,
        moe_num_experts=min(cfg.moe_num_experts, 8),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        # dropless at smoke scale: capacity >= tokens*top_k so decode and
        # teacher-forcing see identical routing regardless of batch length
        moe_capacity_factor=float(min(cfg.moe_num_experts, 8) or 1),
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        qk_nope_dim=32 if cfg.attn_type == "mla" else cfg.qk_nope_dim,
        qk_rope_dim=16 if cfg.attn_type == "mla" else cfg.qk_rope_dim,
        v_head_dim=32 if cfg.attn_type == "mla" else cfg.v_head_dim,
        sliding_window=16 if cfg.sliding_window else 0,
        vision_prefix_tokens=8 if cfg.vision_prefix_tokens else 0,
        encoder_seq_len=64 if cfg.is_encoder_decoder else cfg.encoder_seq_len,
        decoder_text_len=16 if cfg.is_encoder_decoder else cfg.decoder_text_len,
        rwkv_head_dim=32 if cfg.ssm_type == "rwkv6" else cfg.rwkv_head_dim,
        dtype="float32",
    )
