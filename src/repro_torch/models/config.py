"""Unified model configuration for the LM zoo (the ten language-model
architectures) and the shape grid they are dry-run over."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import torch_dtype


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1      # every n-th layer is MoE (within pattern)
    moe_first_dense: int = 0       # leading dense layers (deepseek)
    moe_capacity_factor: float = 2.0

    # --- attention pattern ---
    attn_type: str = "gqa"         # gqa | mla | none
    sliding_window: int = 0        # >0: local attention window
    local_global_period: int = 0   # gemma3: 5 local + 1 global => 6
    rope_theta: float = 1_000_000.0

    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- hybrid / ssm ---
    attn_layer_period: int = 0     # jamba: 1 attn layer per this many
    ssm_type: str = ""             # mamba | rwkv6
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_decoder_layers: int = 0
    encoder_seq_len: int = 1500    # whisper: 30s of audio frames
    decoder_text_len: int = 448

    # --- modality frontend stubs ---
    frontend: str = ""             # "" | vision_stub | audio_stub
    vision_prefix_tokens: int = 0  # qwen2-vl: patch-embedding prefix

    # --- misc ---
    ffn_act: str = "swiglu"        # swiglu | gelu | relu_sq
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # the paper's technique applied to the vocab table (hot-first gather);
    # carried for the configs' sake, read by no model yet
    pinned_vocab_rows: int = 0
    source: str = ""               # provenance tag from the assignment list

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear-attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models import registry  # local import: a cycle
        return registry.analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import registry
        return registry.analytic_param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (arch x shape) grid."""

    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """All four shapes, minus long_500k for quadratic-attention archs."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out
