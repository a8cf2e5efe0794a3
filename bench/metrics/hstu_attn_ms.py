"""hstu_attn_ms (ms): device time a batch launched under the program's
`repro_torch.hstu.attention` span: `kernels.hstu_attention`, its checks to
the launch, once a layer (`bench/harness/spans.py`)."""
from bench.harness import spans


def read(m):
    return spans.ms_per_batch(m.trace, {"hstu.attention"})
