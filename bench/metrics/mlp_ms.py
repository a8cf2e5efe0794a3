"""mlp_ms (ms): device time a batch launched under the program's
`repro_torch.dlrm.bottom` and `repro_torch.dlrm.top` spans, the two MLP
towers: their GEMMs, bias adds and ReLUs (`bench/harness/spans.py`)."""
from bench.harness import spans


def read(m):
    return spans.ms_per_batch(m.trace, {"dlrm.bottom", "dlrm.top"})
