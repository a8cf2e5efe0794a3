"""dcn_cross_roofline (%): the cross network's share of its FLOP bound.

The bound is the cross network's operations (`bench/models/dlrm_dcnv2.py`
`work`: `cross_flops`, two products a layer and its elementwise terms)
over the H100's float32 peak of 67 TFLOP/s (the configuration states
float32 with TF32 off). The time is the device time of every operation
that the slice's batches launched under the program's
`repro_torch.dlrm.cross` span (`bench/harness/spans.py`)."""
from bench.harness import spans
from bench.harness.peaks import PEAK_FLOPS_F32


def read(m):
    found = spans.of(m.trace)
    if not found:
        return None
    seconds = 1e-6 * sum(op.dur_us for op, s in zip(m.trace.ops, found)
                         if "dlrm.cross" in s)
    need = sum(w.get("cross_flops", 0) for w in m.work)
    if seconds <= 0 or need <= 0:
        return None
    return 100.0 * need / PEAK_FLOPS_F32 / seconds
