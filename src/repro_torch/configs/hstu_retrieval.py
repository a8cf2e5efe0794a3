"""hstu-retrieval — HSTU generative retrieval (Zhai et al., arXiv:2402.17152,
§2.1 and §4; the reference code's public experiments): each user's history
of interleaved item and action tokens through hstu-ranking's 8-layer
encoder, causal over the history alone; the last action token's state,
L2-normalised, is the query, and the 256 item rows of largest dot product
with it are retrieved by an exact scan of the whole corpus.

The encoder's widths are hstu-ranking's (assumed there: the paper does not
publish them). N = 8,192: the paper's history length with no candidates.
K = 256 is what the ranking cell scores a user, so retrieval hands ranking
its candidates. The corpus is 50 M items of d = 512 in bf16 (51.2 GB; 102.4
GB in f32), held whole on every serving card, requests spread over the
cards; every row is eligible, ties go to the smaller row. Float32 with
TF32 off; the scan's products are f32 (FFMA on rows widened exactly).
"""
from repro_torch.models.hstu import HSTUConfig

CONFIG = HSTUConfig(
    d_model=512,
    heads=4,
    d_qk=128,
    d_v=128,
    layers=8,
    max_seq_len=8192,
    time_buckets=128,
    task_mlp=(),
    item_rows=50_000_000,
    action_rows=64,
    table_dtype="bfloat16",
    eps=1e-6,
    retrieve_k=256,
)
