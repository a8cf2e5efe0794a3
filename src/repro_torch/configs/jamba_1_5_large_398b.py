"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    moe_num_experts=16, moe_top_k=2, moe_d_ff=24576, moe_layer_period=2,
    attn_layer_period=8, ssm_type="mamba", ssm_state_dim=16, ssm_conv_dim=4,
    source="arXiv:2403.19887; hf",
)
