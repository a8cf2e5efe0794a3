"""Model construction + analytic parameter/FLOP accounting."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import WhisperModel
from repro_torch.models.transformer import TransformerLM, build_plan


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0):
    if cfg.is_encoder_decoder:
        return WhisperModel(cfg, device=device, seed=seed)
    return TransformerLM(cfg, device=device, seed=seed)


def abstract_params(cfg: ModelConfig):
    """(the model built on the meta device, its parameters by name): the
    shapes and dtypes without allocating a byte (`jax.eval_shape`'s
    counterpart)."""
    model = build_model(cfg, device=torch.device("meta"))
    return model, dict(model.named_parameters())


def param_count(cfg: ModelConfig) -> int:
    _, params = abstract_params(cfg)
    return sum(p.numel() for p in params.values())


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    n = param_count(cfg)
    if active_only and cfg.moe_num_experts and not cfg.is_encoder_decoder:
        n_moe_layers = sum(1 for s in build_plan(cfg).layers()
                           if s.ffn == "moe")
        inactive = cfg.moe_num_experts - cfg.moe_top_k
        n -= n_moe_layers * inactive * 3 * cfg.d_model * cfg.moe_d_ff
    return n


def model_flops(cfg: ModelConfig, tokens: int, kind: str = "train") -> float:
    """MODEL_FLOPS: 6*N*D train (dense), 6*N_active*D (MoE); 2*N*D decode."""
    n = analytic_param_count(cfg, active_only=True)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
