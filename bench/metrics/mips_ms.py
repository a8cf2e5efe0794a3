"""mips_ms (ms): device time a batch launched under the program's
`repro_torch.hstu.mips` span: `kernels.mips_topk`, its checks to the
launches, the scan of every item row and the merge
(`bench/harness/spans.py`)."""
from bench.harness import spans


def read(m):
    return spans.ms_per_batch(m.trace, {"hstu.mips"})
