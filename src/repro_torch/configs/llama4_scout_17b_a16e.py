"""llama4-scout-17b-a16e [moe] — MoE 16e top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe_num_experts=16, moe_top_k=1, moe_num_shared=1, moe_d_ff=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
