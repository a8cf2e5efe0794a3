"""dlrm-dcnv2 — MLPerf's recommendation model, DLRM-DCNv2 on Criteo 1TB
multi-hot (mlcommons/training `recommendation_v2/torchrec_dlrm`, its
README's run flags; MLPerf Inference's `dlrm-v2`): 13 dense inputs, bottom
MLP 512-256-128, 26 tables of dim 128 with 3 to 40 M rows and multi-hot
bags of 1 to 100 lookups (214 a sample), sum pooling, a low-rank cross
network of 3 layers of rank 512 (DCN V2, arXiv:2008.13535) over the
27 x 128 = 3,456 features, and top MLP 1024-1024-512-256-1.

The tables are bf16: 204,184,588 rows are 104.5 GB in f32, more than one
H100 holds, and 52.27 GB in bf16. The pooled bags, the cross network and
the MLPs are f32."""
from repro_torch.core.embedding import RaggedStageConfig
from repro_torch.models.dlrm import DLRMConfig

TABLE_ROWS = (40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543,
              63, 40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4,
              976, 14, 40_000_000, 40_000_000, 40_000_000, 590_152, 12_973,
              108, 36)
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)

CONFIG = DLRMConfig(
    dense_features=13,
    bottom_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    embedding=RaggedStageConfig(
        dim=128, dtype="bfloat16", combine="sum",
        table_rows=TABLE_ROWS, table_pooling=MULTI_HOT),
    interaction="dcn",
    dcn_layers=3,
    dcn_rank=512,
    dtype="float32",
)
