"""step_mfu (%): the whole step's share of the chip's peak.

The least time a batch could take is the larger of its operations over the
float32 peak (67 TFLOP/s: the configurations state float32 with TF32
off) and its bytes over 3.35 TB/s, both counted from the shapes and
the batch's distinct rows (`work`: `step_flops`, `step_bytes`). Summed over
the slice's batches, it is set against the slice's length: the measured
time of those steps, idle gaps included.
"""
from bench.harness.peaks import least_seconds


def read(m):
    if not m.trace.batches or m.trace.window_s <= 0:
        return None
    need = sum(least_seconds(w["step_flops"], w["step_bytes"])
               for w in m.work if "step_flops" in w and "step_bytes" in w)
    return 100.0 * need / m.trace.window_s if need > 0 else None
