"""rwkv6-7b [ssm] — Finch: data-dependent decay linear attention, attn-free.
[arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    attn_type="none", ssm_type="rwkv6", rwkv_head_dim=64,
    source="arXiv:2404.05892; hf",
)
