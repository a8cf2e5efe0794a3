"""dcn_bag_roofline (%): the ragged bag kernel's share of its byte bound.

The bound is what the embedding stage needs, whatever implements it: each
distinct (table, row) of a batch read once, each int32 index read once,
each pooled bag written once in float32 (`bench/models/dlrm_dcnv2.py`
`work`: `bag_bytes`), over the H100's 3.35 TB/s. The time is the device
time of the kernels named `ragged_bag_kernel` that the slice's batches
launched under the program's `repro_torch.embedding_bag.ragged_launch`
span (`bench/harness/spans.py`)."""
import re

from bench.harness import spans
from bench.harness.peaks import HBM_BW

KERNEL = re.compile(r"\bragged_bag_kernel\b")


def read(m):
    found = spans.of(m.trace)
    if not found:
        return None
    seconds = 1e-6 * sum(
        op.dur_us for op, s in zip(m.trace.ops, found)
        if "embedding_bag.ragged_launch" in s and KERNEL.search(op.name))
    need = sum(w.get("bag_bytes", 0) for w in m.work)
    if seconds <= 0 or need <= 0:
        return None
    return 100.0 * need / HBM_BW / seconds
