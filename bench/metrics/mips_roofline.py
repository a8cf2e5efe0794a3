"""mips_roofline (%): the exact top-K scan's share of its byte bound.

The bound is what the retrieval stage must move, whatever implements it:
each item row read once, the queries read once, each retrieved id and
score written once (`bench/models/hstu_retrieval.py` `work`: `mips_bytes`),
over the H100's 3.35 TB/s. It counts bytes alone, so a scan on the tensor
cores cannot read above 100 %. The time is the device time of every
operation that the slice's batches launched under the program's
`repro_torch.hstu.mips` span (`bench/harness/spans.py`)."""
from bench.harness import spans
from bench.harness.peaks import HBM_BW


def read(m):
    found = spans.of(m.trace)
    if not found:
        return None
    seconds = 1e-6 * sum(op.dur_us for op, s in zip(m.trace.ops, found)
                         if "hstu.mips" in s)
    need = sum(w.get("mips_bytes", 0) for w in m.work)
    if seconds <= 0 or need <= 0:
        return None
    return 100.0 * need / HBM_BW / seconds
