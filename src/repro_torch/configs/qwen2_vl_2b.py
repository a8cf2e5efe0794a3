"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution; vision frontend is a STUB
(input_specs provides precomputed patch embeddings as a 256-token prefix).
M-RoPE degenerates to 1-D RoPE for sequential positions (models/layers.py).
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, tie_embeddings=True,
    frontend="vision_stub", vision_prefix_tokens=256,
    source="arXiv:2409.12191; hf",
)
