"""hstu_attn_roofline (%): the HSTU attention kernel's share of its FLOP
bound.

The bound is the attention's operations over the pairs the mask lets in
(`bench/models/hstu.py` `work`: `attn_flops`, 2 h (d_qk + d_v) a pair and
layer) over the H100's float32 peak of 67 TFLOP/s (the configuration
states float32 with TF32 off). The time is the device time of every
operation that the slice's batches launched under the program's
`repro_torch.hstu.attention` span (`bench/harness/spans.py`)."""
from bench.harness import spans
from bench.harness.peaks import PEAK_FLOPS_F32


def read(m):
    found = spans.of(m.trace)
    if not found:
        return None
    seconds = 1e-6 * sum(op.dur_us for op, s in zip(m.trace.ops, found)
                         if "hstu.attention" in s)
    need = sum(w.get("attn_flops", 0) for w in m.work)
    if seconds <= 0 or need <= 0:
        return None
    return 100.0 * need / PEAK_FLOPS_F32 / seconds
