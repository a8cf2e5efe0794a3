"""hstu-ranking — HSTU generative ranking (Zhai et al., arXiv:2402.17152,
§3): 8 layers of pointwise SiLU attention over a user's interleaved item
and action tokens, with a relative position and time-bucket bias, and 256
candidates a user scored in one target-aware pass (M-FALCON, §3.4) through
a task MLP 512-256-1.

The paper publishes the equations, sequences of 8,192 and the 1.5 T-
parameter scale, not its production widths: d_model 512, 4 heads of 128
(the reference code's d_model / heads), 8 layers, the task MLP and 64
action rows are assumed. The item table is sharded row-wise over 64 cards
(3.2 B rows, about 1.6 T parameters); one card holds its 50 M-row slice,
in bf16 (51.2 GB; 102.4 GB in f32). The encoder computes in f32 with TF32
off, where the reference code computes in bf16.
"""
from repro_torch.models.hstu import HSTUConfig

CONFIG = HSTUConfig(
    d_model=512,
    heads=4,
    d_qk=128,
    d_v=128,
    layers=8,
    max_seq_len=8448,
    time_buckets=128,
    task_mlp=(512, 256, 1),
    item_rows=50_000_000,
    action_rows=64,
    table_dtype="bfloat16",
    eps=1e-6,
)
