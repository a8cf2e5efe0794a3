"""The program's spans (`repro_torch.*`) in a traced slice: which spans
each device operation was launched under (`bench/harness/spans.py`), the
readers of `interact_ms` and `mlp_ms`, and that the benchmark's own
ranges, readers and idle gaps read the same with the spans in the trace.
A Chrome trace made by hand, as `test_bench_trace.py` makes one, and a
tiny cell traced on the card (marked `cuda`)."""
import json
import os
import time

import pytest

from bench.harness import runner, spans, spec, trace
from bench.harness.runner import MetricInput
from bench.tests.conftest import tiny_cell

HOST, DEV = 1, 7
EXISTING = ("bag_roofline", "embedding_ms", "dense_ms", "step_mfu",
            "device_idle", "dispatch_ms")


def x(cat, name, ts, dur, tid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def span(name, ts, dur):
    return x("user_annotation", "repro_torch." + name, ts, dur)


def batch(k, t0, corr):
    """Dispatch k from t0 as the traced DLRM forward marks it: the
    benchmark's ranges, the program's spans inside them, and six device
    ops: the bag kernel, a bottom GEMM, the Gram bmm and the pair gather,
    a top GEMM, and the logits' copy outside the forward."""
    def launch(ts, c, name="cudaLaunchKernel"):
        return x("cuda_runtime", name, ts, 1, correlation=c)

    def dev(cat, name, ts, dur, c):
        return x(cat, name, ts, dur, tid=DEV, correlation=c)

    return [
        x("user_annotation", f"bench.batch.{k}", t0, 40),
        x("user_annotation", "bench.forward", t0 + 1, 35),
        span("dlrm.forward", t0 + 1.5, 34),
        x("user_annotation", "bench.ebc", t0 + 2, 8),
        span("ebc.lookup", t0 + 2.5, 7),
        x("cpu_op", "EmbeddingBagFunction", t0 + 3, 6),
        span("embedding_bag.launch", t0 + 3.5, 5),
        launch(t0 + 6, corr),
        x("user_annotation", "bench.bottom", t0 + 11, 5),
        span("dlrm.bottom", t0 + 11.5, 4),
        x("cpu_op", "aten::mm", t0 + 12, 2),
        launch(t0 + 12.5, corr + 1),
        span("dlrm.interact", t0 + 17, 8),
        x("cpu_op", "aten::bmm", t0 + 18, 2),
        launch(t0 + 18.5, corr + 2),
        x("cpu_op", "aten::index", t0 + 21, 2),
        launch(t0 + 21.5, corr + 3),
        x("user_annotation", "bench.top", t0 + 27, 6),
        span("dlrm.top", t0 + 27.5, 5),
        x("cpu_op", "aten::mm", t0 + 28, 3),
        launch(t0 + 29, corr + 4),
        launch(t0 + 38, corr + 5, "cudaMemcpyAsync"),
        dev("kernel", "void ns::bag_kernel<float, true, false, 4>(P)",
            t0 + 15, 40, corr),
        dev("kernel", "sm80_xmma_gemm_f32 bottom", t0 + 55, 10, corr + 1),
        dev("kernel", "sm80_xmma_gemm_f32 tn", t0 + 65, 6, corr + 2),
        dev("kernel", "index_elementwise_kernel", t0 + 71, 4, corr + 3),
        dev("kernel", "sm80_xmma_gemm_f32 top", t0 + 75, 8, corr + 4),
        dev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", t0 + 83, 5,
            corr + 5),
    ]


def events(program_spans=True):
    evs = (batch(4, 0, 10) + batch(5, 100, 20) + batch(6, 200, 30)
           + [x("user_annotation", "bench.slice", 95, 200)])
    if not program_spans:
        evs = [e for e in evs if not e["name"].startswith("repro_torch.")]
    return evs


def write(name, evs):
    path = runner.OUT / name / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": evs}))
    return path


def readout_of(path):
    return trace.read(path, batches=range(5, 7))


def metric(name, m):
    return spec.load_module("metrics", name).read(m)


def inputs(readout):
    work = [{"bag_bytes": 3.35e12 * 20e-6, "step_bytes": 3.35e12 * 30e-6,
             "step_flops": 1.0}] * 2
    return MetricInput(trace=readout, work=work, dispatch_s=[1e-3, 3e-3])


def test_each_op_carries_the_spans_open_at_its_launch():
    r = readout_of(write("cell", events()))
    found = dict(zip((op.name.split("(")[0] for op in r.ops),
                     spans.of(r)))
    fwd = {"dlrm.forward"}
    assert found["void ns::bag_kernel<float, true, false, 4>"] == fwd | {
        "ebc.lookup", "embedding_bag.launch"}
    assert found["sm80_xmma_gemm_f32 bottom"] == fwd | {"dlrm.bottom"}
    assert found["sm80_xmma_gemm_f32 tn"] == fwd | {"dlrm.interact"}
    assert found["index_elementwise_kernel"] == fwd | {"dlrm.interact"}
    assert found["sm80_xmma_gemm_f32 top"] == fwd | {"dlrm.top"}
    assert found["Memcpy DtoH "] == frozenset()
    assert len(spans.of(r)) == len(r.ops) == 12


def test_interact_and_mlp_read_the_spans():
    r = readout_of(write("cell", events()))
    m = inputs(r)
    assert metric("interact_ms", m) == pytest.approx(0.010)   # 6 + 4 us
    assert metric("mlp_ms", m) == pytest.approx(0.018)        # 10 + 8 us
    # the two split the dense part that the benchmark's ranges see
    assert metric("interact_ms", m) + metric("mlp_ms", m) == pytest.approx(
        metric("dense_ms", m))


def test_readers_return_nothing_without_their_ops():
    r = readout_of(write("cell", events()))
    r.ops = [op for op in r.ops if "gemm" not in op.name
             and "index" not in op.name]
    m = inputs(r)
    assert metric("interact_ms", m) is None
    assert metric("mlp_ms", m) is None


def test_a_program_without_spans_reads_as_none_and_the_rest_unchanged():
    """An older tree traced with these readers: no span in the trace, so
    the two new metrics are left out, and the benchmark's own readout is
    what the same trace with the spans reads."""
    plain_path = write("plain", events(program_spans=False))
    plain = readout_of(plain_path)
    assert metric("interact_ms", inputs(plain)) is None
    assert metric("mlp_ms", inputs(plain)) is None
    plain_path.unlink()      # the marked trace has the same device ops
    marked = readout_of(write("marked", events()))
    assert [op.ranges for op in plain.ops] == [op.ranges for op in marked.ops]
    assert [op.batch for op in plain.ops] == [op.batch for op in marked.ops]
    assert (plain.window_s, plain.busy_s, plain.top_ops) == (
        marked.window_s, marked.busy_s, marked.top_ops)
    for name in EXISTING:
        assert metric(name, inputs(plain)) == pytest.approx(
            metric(name, inputs(marked)))


def test_idle_gap_before_the_bag_kernel_names_its_launch_span():
    r = readout_of(write("cell", events()))
    label = "ebc/forward: repro_torch.embedding_bag.launch"
    # device idle 95..115 and 188..215 end at a bag kernel; 288..295 ends
    # the slice
    assert [n for n, _ in r.idle_gaps] == [label, label, "end of slice"]
    assert [s for _, s in r.idle_gaps] == pytest.approx(
        [27e-6, 20e-6, 7e-6])


def test_the_readouts_own_trace_is_found_among_others():
    mine = write("mine", events())
    r = readout_of(mine)
    other = events()
    for e in other:
        if e.get("tid") == DEV:
            e["ts"] += 0.5           # another run: other device times
    newer = write("other", other)
    later = time.time() + 10
    os.utime(newer, (later, later))
    assert spans.of(r) is not None
    assert metric("interact_ms", inputs(r)) == pytest.approx(0.010)
    mine.unlink()
    assert spans.of(r) is None
    assert metric("interact_ms", inputs(r)) is None


@pytest.mark.cuda
def test_spans_on_the_card(cuda_device):
    """A tiny cell traced on the card: every op of the forward falls under
    `dlrm.forward`, the bag kernel under `embedding_bag.launch`, the
    benchmark's `ebc` range and the program's `ebc.lookup` span hold the
    same ops, and `interact_ms` + `mlp_ms` is the dense part."""
    cell = tiny_cell("med_hot", rows=20_000, dim=128, pooling=40,
                     num_tables=16, batch=512, bottom_mlp=[64, 128])
    _, _, window, _ = runner.open_window(
        cell, 2**31 + 3, 1.0, True, cuda_device, time.perf_counter())
    r = window.trace
    found = spans.of(r)
    assert found is not None and len(found) == len(r.ops)
    for op, s in zip(r.ops, found):
        assert ("forward" in op.ranges) == ("dlrm.forward" in s), op.name
        assert ("ebc" in op.ranges) == ("ebc.lookup" in s), op.name
        if "bag_kernel" in op.name:
            assert "embedding_bag.launch" in s
    m = MetricInput(trace=r, work=[], dispatch_s=[])
    interact, mlp = metric("interact_ms", m), metric("mlp_ms", m)
    assert interact > 0 and mlp > 0
    assert interact + mlp == pytest.approx(metric("dense_ms", m), rel=0.05)
