"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA, tied embeddings.
[arXiv:2412.08905; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064, tie_embeddings=True,
    source="arXiv:2412.08905; hf",
)
