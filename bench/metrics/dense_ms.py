"""dense_ms (ms): device time a batch launched by the forward outside
`model.ebc`: the MLP towers, the dot interaction and their glue (cuBLAS
and elementwise kernels)."""


def read(m):
    if not m.trace.batches:
        return None
    seconds = m.trace.op_seconds(
        lambda op: "forward" in op.ranges and "ebc" not in op.ranges)
    return seconds * 1e3 / len(m.trace.batches) if seconds > 0 else None
