"""The DLRM-DCNv2 cell (`bench/models/dlrm_dcnv2.py`): its work counts
worked by hand, the readers of its metrics (its three `dcn_*` ones and
the accepted ones that list the cell) on a Chrome trace made by hand (as
`test_bench_spans.py` makes one), a cut-down cell run end to end
on the CPU against its limits and its control, and the same cell traced
on the card (marked `cuda`)."""
import time

import pytest
import torch

from bench.harness import check, runner, spec, trace
from bench.harness.runner import MetricInput
from bench.reference import dlrm_dcnv2 as reference
from bench.tests.conftest import run_tiny
from bench.tests.test_bench_spans import DEV, span, write, x

CELL = "dlrm-dcnv2.med_hot"
DCN_METRICS = ("dcn_cross_ms", "dcn_cross_roofline", "dcn_bag_roofline")
METRICS = DCN_METRICS + ("embedding_ms", "dense_ms", "step_mfu",
                         "device_idle", "dispatch_ms", "interact_ms",
                         "mlp_ms")
SMALL = dict(num_embeddings_per_feature=[3, 10, 40, 1000, 7],
             multi_hot_sizes=[1, 3, 2, 12, 1], dim=16, dense_features=13,
             bottom_mlp=[32, 16], top_mlp=[32, 16, 1], dcn_rank=8,
             dcn_layers=2)


def model():
    return spec.load_module("models", "dlrm_dcnv2")


def small_cell(batch=64, **config) -> spec.Cell:
    """The DLRM-DCNv2 cell cut to a CPU test's size, held to its limits."""
    cell = spec.load_cell(CELL)
    cell.config = {**cell.config, **SMALL, **config}
    cell.traffic = {**cell.traffic, "batch": batch}
    return cell


def test_work_of_a_hand_worked_batch():
    cfg = dict(num_embeddings_per_feature=[10, 4], multi_hot_sizes=[3, 1],
               dim=2, dense_features=3, bottom_mlp=[2], top_mlp=[5, 1],
               dcn_layers=1, dcn_rank=3, dtype="float32",
               table_dtype="bfloat16")
    # B=2: table 0 reads rows {1, 2, 3, 9}, table 1 row {3}: the same id
    # in two tables is two rows
    idx = torch.tensor([[1, 3, 2, 3], [2, 9, 1, 3]], dtype=torch.int32)
    inputs = model().Inputs(tables=None, bottom=None, cross=None, top=None,
                            pool=[(torch.zeros((2, 3)), idx)])
    w = model().work(cfg, inputs, 0)
    assert w["distinct_rows"] == 5
    rows, index, pooled = 5 * 2 * 2, 8 * 4, 2 * 2 * 2 * 4
    assert w["bag_bytes"] == rows + index + pooled
    # one cross layer over x0 of (2 + 1) x 2 = 6: two products of 6 x 3,
    # then the bias add, product and sum, for each of 2 samples
    assert w["cross_flops"] == 2 * (2 * 6 * 3 * 2 + 3 * 6)
    mlp = 2 * 2 * (3 * 2 + 6 * 5 + 5 * 1)
    pool = 2 * ((3 - 1) + (1 - 1)) * 2
    assert w["step_flops"] == mlp + pool + w["cross_flops"]
    # dense weights: bottom 3x2+2; top 6x5+5, 5x1+1; cross 6x3+3x6+6
    params = 8 + 35 + 6 + 42
    assert w["step_bytes"] == rows + index + 2 * 3 * 4 + params * 4 + 2 * 4


def test_distinct_rows_are_counted_per_table():
    cfg = dict(num_embeddings_per_feature=[5, 5, 5],
               multi_hot_sizes=[2, 1, 1])
    idx = torch.tensor([[0, 0, 0, 4], [0, 1, 0, 4]], dtype=torch.int32)
    assert model().distinct_rows(cfg, idx) == 4     # (0,0) (0,1) (1,0) (2,4)


def dcn_batch(k, t0, corr):
    """Dispatch k of a traced DLRM-DCNv2 forward: the ragged bag kernel,
    a bottom GEMM, the cat of the features (under `dlrm.interact` only),
    two cross GEMMs and a cross term (under `dlrm.cross`), a top GEMM and
    the logits' copy."""
    def launch(ts, c, name="cudaLaunchKernel"):
        return x("cuda_runtime", name, ts, 1, correlation=c)

    def dev(name, ts, dur, c, cat="kernel"):
        return x(cat, name, ts, dur, tid=DEV, correlation=c)

    return [
        x("user_annotation", f"bench.batch.{k}", t0, 40),
        x("user_annotation", "bench.forward", t0 + 1, 35),
        span("dlrm.forward", t0 + 1.5, 34),
        x("user_annotation", "bench.ebc", t0 + 2, 8),
        span("ebc.lookup", t0 + 2.5, 7),
        span("embedding_bag.ragged_launch", t0 + 3.5, 5),
        launch(t0 + 6, corr),
        x("user_annotation", "bench.bottom", t0 + 11, 4),
        span("dlrm.bottom", t0 + 11.5, 3),
        launch(t0 + 12, corr + 1),
        span("dlrm.interact", t0 + 16, 12),
        launch(t0 + 17, corr + 2),
        span("dlrm.cross", t0 + 18, 9),
        launch(t0 + 19, corr + 3),
        launch(t0 + 21, corr + 4),
        launch(t0 + 23, corr + 5),
        x("user_annotation", "bench.top", t0 + 29, 5),
        span("dlrm.top", t0 + 29.5, 4),
        launch(t0 + 30, corr + 6),
        launch(t0 + 38, corr + 7, "cudaMemcpyAsync"),
        dev("void ns::ragged_bag_kernel<__nv_bfloat16, true, 4>(P)",
            t0 + 10, 20, corr),
        dev("sm80_xmma_gemm_f32 bottom", t0 + 30, 2, corr + 1),
        dev("CatArrayBatchedCopy", t0 + 32, 3, corr + 2),
        dev("sm80_xmma_gemm_f32 v", t0 + 35, 10, corr + 3),
        dev("sm80_xmma_gemm_f32 w", t0 + 45, 12, corr + 4),
        dev("vectorized_elementwise_kernel addcmul", t0 + 57, 2, corr + 5),
        dev("sm80_xmma_gemm_f32 top", t0 + 59, 8, corr + 6),
        dev("Memcpy DtoH (Device -> Pinned)", t0 + 67, 3, corr + 7,
            "gpu_memcpy"),
    ]


def dcn_events(program_spans=True):
    evs = (dcn_batch(4, 0, 10) + dcn_batch(5, 100, 20)
           + dcn_batch(6, 200, 30)
           + [x("user_annotation", "bench.slice", 95, 200)])
    if not program_spans:
        evs = [e for e in evs if not e["name"].startswith("repro_torch.")]
    return evs


def metric_input(readout):
    # per batch, as time at the peak: bag_bytes 10 us (the kernel takes
    # 20), cross_flops 12 us (the span's ops 24), the step 50 us
    work = [{"bag_bytes": 3.35e12 * 10e-6, "cross_flops": 67e12 * 12e-6,
             "step_flops": 67e12 * 50e-6, "step_bytes": 1.0}] * 2
    return MetricInput(trace=readout, work=work, dispatch_s=[1e-3])


def read(name, m):
    return spec.load_module("metrics", name).read(m)


def test_the_cells_readers_on_a_hand_made_trace():
    r = trace.read(write("dcn", dcn_events()), batches=range(5, 7))
    m = metric_input(r)
    assert read("dcn_cross_ms", m) == pytest.approx(0.024)   # 10 + 12 + 2
    assert read("dcn_cross_roofline", m) == pytest.approx(50.0)
    assert read("dcn_bag_roofline", m) == pytest.approx(50.0)  # 10 of 20
    assert read("embedding_ms", m) == pytest.approx(0.020)
    assert read("step_mfu", m) == pytest.approx(100.0 * 100e-6 / 200e-6)
    # the cat under dlrm.interact is not the cross network's
    assert read("interact_ms", m) == pytest.approx(0.027)
    assert read("mlp_ms", m) == pytest.approx(0.010)          # 2 + 8
    # bottom 2, cat 3, cross 24, top 8: all but the ragged kernel
    assert read("dense_ms", m) == pytest.approx(0.037)
    # batches 5 and 6 keep the card busy 60 us each of the 200 us slice
    assert read("device_idle", m) == pytest.approx(40.0)
    assert read("dispatch_ms", m) == pytest.approx(1.0)


def test_the_readers_read_none_without_their_ops():
    r = trace.read(write("dcn", dcn_events()), batches=range(5, 7))
    r.ops = [op for op in r.ops if "gemm" not in op.name
             and "addcmul" not in op.name and "ragged" not in op.name]
    m = metric_input(r)
    for name in DCN_METRICS + ("embedding_ms", "mlp_ms"):
        assert read(name, m) is None, name
    # only the cat of the features is left of the dense work
    assert read("interact_ms", m) == pytest.approx(0.003)
    assert read("dense_ms", m) == pytest.approx(0.003)
    empty = MetricInput(trace=r, work=[], dispatch_s=[])
    assert read("step_mfu", empty) is None
    assert read("dispatch_ms", empty) is None


def test_a_program_without_spans_reads_as_none():
    r = trace.read(write("plain", dcn_events(program_spans=False)),
                   batches=range(5, 7))
    m = metric_input(r)
    for name in DCN_METRICS + ("interact_ms", "mlp_ms"):
        assert read(name, m) is None, name
    # the benchmark's own ranges still read
    assert read("step_mfu", m) == pytest.approx(50.0)
    assert read("embedding_ms", m) == pytest.approx(0.020)


def test_reference_matches_port_cpu_path():
    cell = small_cell()
    dev = torch.device("cpu")
    inputs = model().make_inputs(cell.config, cell.traffic, 2**31 + 9, dev)
    program = model().build_program(cell.config, inputs, dev)
    for k in range(len(inputs.pool)):
        dense, idx = inputs.pool[k]
        assert idx.shape == (64, 19) and idx.dtype == torch.int32
        with torch.inference_mode():
            got_bags = program.ebc(idx)
            got = program(dense, idx)
        bags, logits = model().reference_outputs(cell.config, inputs, k)
        torch.testing.assert_close(got_bags, bags, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got, logits, rtol=1e-5, atol=1e-5)


def test_ids_stay_in_each_tables_rows():
    cell = small_cell()
    inputs = model().make_inputs(cell.config, cell.traffic, 11, "cpu")
    idx = torch.cat([i for _, i in inputs.pool])
    col = 0
    for rows, pool in zip(SMALL["num_embeddings_per_feature"],
                          SMALL["multi_hot_sizes"]):
        ids = idx[:, col:col + pool]
        assert int(ids.min()) >= 0 and int(ids.max()) < rows
        col += pool
    # the 3-row table saturates: every row is drawn
    assert set(idx[:, 0].tolist()) == {0, 1, 2}


def test_reference_blocks_agree_with_one_block(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    rows, bags = [7, 30], [2, 5]
    tables = torch.randn((37, 8), generator=gen).to(torch.bfloat16)
    idx = torch.cat([torch.randint(0, 7, (9, 2), generator=gen),
                     torch.randint(0, 30, (9, 5), generator=gen)], 1)
    whole = reference.pooled(tables, rows, bags, idx)
    monkeypatch.setattr(reference, "BLOCK_BYTES", 5 * 8 * 4 * 2)
    torch.testing.assert_close(reference.pooled(tables, rows, bags, idx),
                               whole, rtol=0, atol=0)
    by_hand = torch.stack([tables[:7][idx[:, :2]].float().sum(1),
                           tables[7:][idx[:, 2:]].float().sum(1)], 1)
    torch.testing.assert_close(whole, by_hand, rtol=0, atol=0)


def test_small_cell_runs_correct_and_the_control_does_not():
    cell = small_cell()
    seed = 2**31 + 41          # holds dispatches 0 and 2: early in any window
    out = run_tiny(cell, seed=seed)
    r = out["result"]
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    mod, inputs, window, _ = runner.open_window(
        cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter())
    ref = runner.reference_outputs(mod, cell.config, inputs, window)
    ctl = runner.reference_outputs(mod, cell.config, inputs, window,
                                   lower=True)
    values = check.readings(check.control_window(window, ctl), ref)
    ok, _ = check.judge(values, cell.limits)
    assert not ok
    assert values["pooled_gap"] > cell.limits["pooled_gap"]["limit"]


def test_same_seed_same_inputs():
    cell = small_cell()
    a = model().make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    b = model().make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    c = model().make_inputs(cell.config, cell.traffic, 2**31 + 6, "cpu")
    assert torch.equal(a.tables, b.tables)
    assert all(torch.equal(p[1], q[1]) for p, q in zip(a.pool, b.pool))
    assert not torch.equal(a.pool[0][1], c.pool[0][1])


@pytest.mark.cuda
def test_small_cell_on_the_card(cuda_device):
    """The cell at the published dim and bag sizes, with small tables and
    batch, traced on the card: correct, one ragged launch a forward, and
    every one of its per-layer metrics read, each share within 100 %."""
    cell = small_cell(batch=1024, dim=128, bottom_mlp=[64, 128],
                      dcn_rank=512, dcn_layers=3,
                      multi_hot_sizes=[3, 100, 1, 27, 12],
                      num_embeddings_per_feature=[3, 200_000, 7, 50_000,
                                                  100_000])
    out = run_tiny(cell, seed=2**31 + 21, seconds=1.0, device=cuda_device,
                   trace=True)
    r = out["result"]
    assert r["correct"] is True, r["check"]
    assert out["side"]["bag_launches_per_forward"] == 1.0
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(METRICS)
    assert 0 < m["dcn_bag_roofline"] <= 100
    assert 0 < m["dcn_cross_roofline"] <= 100
    assert 0 < m["step_mfu"] <= 100
    assert 0 <= m["device_idle"] <= 100
    for name in ("dcn_cross_ms", "embedding_ms", "dense_ms", "dispatch_ms",
                 "interact_ms", "mlp_ms"):
        assert 0 < m[name], name
