"""gemma3-27b [dense] — 5:1 local:global attention, window 1024, 128k ctx.
head_dim=128 (explicit, != d_model/num_heads as in the HF config).
FFN gate uses SiLU in this framework (HF: GeLU-gated).
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    sliding_window=1024, local_global_period=6,
    source="hf:google/gemma-3-1b-pt; unverified",
)
