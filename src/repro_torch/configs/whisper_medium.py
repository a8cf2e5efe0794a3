"""whisper-medium [audio] — enc-dec; conv frontend STUB (precomputed frame
embeddings). 24 encoder + 24 decoder layers, absolute positions (no RoPE).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865, ffn_act="gelu",
    is_encoder_decoder=True, num_decoder_layers=24,
    frontend="audio_stub",
    source="arXiv:2212.04356; unverified",
)
