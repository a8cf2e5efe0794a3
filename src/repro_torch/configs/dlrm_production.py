"""dlrm-production — the paper's own model (§V): 250 tables x 500K x 128,
bottom MLP 1024-512-128-128, top MLP 128-64-1, batch 2048, pooling 150."""
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.models.dlrm import DLRMConfig

CONFIG = DLRMConfig(
    dense_features=13,
    bottom_mlp=(1024, 512, 128, 128),
    top_mlp=(128, 64, 1),
    embedding=EmbeddingStageConfig(
        num_tables=250, rows=500_000, dim=128, pooling=150,
        # 250 -> 256 so whole tables spread across a 256-device slice
        shard_pad_tables=6),
)
