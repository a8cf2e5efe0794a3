"""bag_roofline (%): the CUDA bag kernel's share of its byte bound.

The bound is what the embedding stage needs, whatever implements it: each
distinct (table, row) of a batch read once, each int32 index read once,
each pooled bag written once (`bench/models/<model>.py` `work`), over the
H100's 3.35 TB/s. The time is the device time of the kernels named
`bag_kernel` that the slice's batches launched under `model.ebc`.
"""
import re

from bench.harness.peaks import HBM_BW

KERNEL = re.compile(r"\bbag_kernel\b")


def read(m):
    seconds = m.trace.op_seconds(
        lambda op: "ebc" in op.ranges and KERNEL.search(op.name))
    need = sum(w.get("bag_bytes", 0) for w in m.work)
    if seconds <= 0 or need <= 0:
        return None
    return 100.0 * need / HBM_BW / seconds
