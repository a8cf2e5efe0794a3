"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512; 2 shared + 64 routed top-6;
first layer dense (d_ff there = 10944 per the HF config; the assignment's
d_ff=1408 is the routed-expert intermediate size). [arXiv:2405.04434; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    attn_type="mla", kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, head_dim=192,
    moe_num_experts=64, moe_top_k=6, moe_num_shared=2, moe_d_ff=1408,
    moe_first_dense=1,
    source="arXiv:2405.04434; hf",
)
