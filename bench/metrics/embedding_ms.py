"""embedding_ms (ms): device time a batch launched under `model.ebc`, the
embedding stage (`EmbeddingBagCollection` -> `storage/device.py` lookup):
the bag kernel and any remap or cast around it."""


def read(m):
    if not m.trace.batches:
        return None
    seconds = m.trace.op_seconds(lambda op: "ebc" in op.ranges)
    return seconds * 1e3 / len(m.trace.batches) if seconds > 0 else None
