"""interact_ms (ms): device time a batch launched under the program's
`repro_torch.dlrm.interact` span, `DLRM._interact`: the dot interaction's
concatenation, Gram product, pair gather and final concatenation
(`bench/harness/spans.py`)."""
from bench.harness import spans


def read(m):
    return spans.ms_per_batch(m.trace, {"dlrm.interact"})
