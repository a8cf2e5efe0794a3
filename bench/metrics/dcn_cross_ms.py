"""dcn_cross_ms (ms): device time a batch launched under the program's
`repro_torch.dlrm.cross` span: DCN V2's cross network in `DLRM._interact`,
its products, bias adds and cross terms (`bench/harness/spans.py`)."""
from bench.harness import spans


def read(m):
    return spans.ms_per_batch(m.trace, {"dlrm.cross"})
