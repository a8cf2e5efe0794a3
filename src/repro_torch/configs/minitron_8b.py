"""minitron-8b [dense] — pruned nemotron (squared-ReLU FFN).
[arXiv:2407.14679; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000, ffn_act="relu_sq",
    source="arXiv:2407.14679; hf",
)
