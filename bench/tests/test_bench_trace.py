"""The trace reader and the per-layer metrics' readers, on a Chrome trace
made by hand: two batches of the slice, one before it."""
import json

import pytest

from bench.harness import spec, trace
from bench.harness.runner import MetricInput

HOST, DEV = 1, 7


def x(cat, name, ts, dur, tid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def batch(k, t0, corr):
    """Host ranges of dispatch k from t0, and its device ops: the bag
    kernel (ebc), a GEMM (forward), the logits' copy (outside the forward)."""
    return [
        x("user_annotation", f"bench.batch.{k}", t0, 20),
        x("user_annotation", "bench.forward", t0 + 1, 15),
        x("user_annotation", "bench.ebc", t0 + 2, 5),
        x("cpu_op", "EmbeddingBagFunction", t0 + 2.5, 4),
        x("cuda_runtime", "cudaLaunchKernel", t0 + 3, 1, correlation=corr),
        x("user_annotation", "bench.top", t0 + 8, 5),
        x("cpu_op", "aten::mm", t0 + 8.5, 4),
        x("cuda_runtime", "cudaLaunchKernel", t0 + 9, 1, correlation=corr + 1),
        x("cuda_runtime", "cudaMemcpyAsync", t0 + 18, 1, correlation=corr + 2),
        x("kernel", "void ns::bag_kernel<float, true, false, 4>(P)",
          t0 + 15, 40, tid=DEV, correlation=corr),
        x("kernel", "sm80_xmma_gemm_f32", t0 + 55, 20, tid=DEV,
          correlation=corr + 1),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", t0 + 75, 5,
          tid=DEV, correlation=corr + 2),
    ]


@pytest.fixture
def readout(tmp_path):
    events = (batch(4, 0, 10) + batch(5, 100, 20) + batch(6, 180, 30)
              + [x("user_annotation", "bench.slice", 95, 170)])
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.read(path, batches=range(5, 7))


def test_ops_are_tied_to_batches_and_layers(readout):
    assert readout.batches == [5, 6]
    assert len(readout.ops) == 6
    bag = [op for op in readout.ops if "bag_kernel" in op.name]
    assert [op.batch for op in bag] == [5, 6]
    assert all(op.ranges == {"forward", "ebc"} for op in bag)
    gemm = [op for op in readout.ops if "gemm" in op.name]
    assert all(op.ranges == {"forward", "top"} for op in gemm)
    copy = [op for op in readout.ops if "Memcpy" in op.name]
    assert all(op.ranges == frozenset() for op in copy)


def test_busy_window_and_gaps(readout):
    assert readout.window_s == pytest.approx(170e-6)
    # device ops [115,180] and [195,260] clipped to [95, 265]
    assert readout.busy_s == pytest.approx(130e-6)
    label = "ebc/forward: EmbeddingBagFunction"
    assert [n for n, _ in readout.idle_gaps] == [label, label, "end of slice"]
    assert [s for _, s in readout.idle_gaps] == pytest.approx(
        [20e-6, 15e-6, 5e-6])          # 95..115, 180..195, 260..265
    assert readout.top_ops[0][0].startswith("void ns::bag_kernel")


def metric(name, m):
    return spec.load_module("metrics", name).read(m)


def test_metric_readers(readout):
    work = [{"bag_bytes": 3.35e12 * 20e-6, "step_bytes": 3.35e12 * 30e-6,
             "step_flops": 1.0}] * 2
    m = MetricInput(trace=readout, work=work, dispatch_s=[1e-3, 3e-3])
    assert metric("bag_roofline", m) == pytest.approx(50.0)
    assert metric("embedding_ms", m) == pytest.approx(0.040)
    assert metric("dense_ms", m) == pytest.approx(0.020)
    assert metric("step_mfu", m) == pytest.approx(100 * 60 / 170)
    assert metric("device_idle", m) == pytest.approx(100 * 40 / 170)
    assert metric("dispatch_ms", m) == pytest.approx(2.0)


def test_readers_return_nothing_without_their_ops(readout):
    readout.ops = [op for op in readout.ops if "bag_kernel" not in op.name]
    m = MetricInput(trace=readout, work=[{}], dispatch_s=[])
    for name in ("bag_roofline", "embedding_ms", "step_mfu", "dispatch_ms"):
        assert metric(name, m) is None
