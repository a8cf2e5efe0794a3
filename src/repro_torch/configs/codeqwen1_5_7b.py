"""codeqwen1.5-7b [dense] — qwen1.5 arch, full MHA (kv=32).
[hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
)
