"""The HSTU generative-ranking cell (`bench/models/hstu.py`): its spec and
files, its work counts worked by hand, the readers of its metrics (its two
`hstu_*` ones and the accepted ones that list the cell) on a Chrome trace
made by hand (as `test_bench_spans.py` makes one), a cut-down cell run end
to end on the CPU against its limits and its control, and the same cell
traced on the card (marked `cuda`)."""
import importlib.util
import time

import pytest
import torch

from bench.harness import check, runner, spec, trace
from bench.harness.peaks import HBM_BW
from bench.harness.runner import MetricInput
from bench.tests.conftest import run_tiny
from bench.tests.test_bench_spans import DEV, span, write, x

CELL = "hstu-ranking.long_hist"
HSTU_METRICS = ("hstu_attn_ms", "hstu_attn_roofline")
METRICS = HSTU_METRICS + ("embedding_ms", "step_mfu", "device_idle",
                          "dispatch_ms", "dense_ms", "dcn_bag_roofline")
SMALL = dict(d_model=32, heads=2, d_qk=16, d_v=16, layers=2,
             max_seq_len=48, time_buckets=128, task_mlp=[16, 8, 1],
             item_rows=1000, action_rows=8)
SMALL_TRAFFIC = dict(users=3, history_min_events=4, history_max_events=16,
                     candidates=4, batch=12)


def model():
    return spec.load_module("models", "hstu")


def small_cell(config=None, traffic=None) -> spec.Cell:
    """The HSTU cell cut to a CPU test's size, held to its limits."""
    cell = spec.load_cell(CELL)
    cell.config = {**cell.config, **SMALL, **(config or {})}
    cell.traffic = {**cell.traffic, **SMALL_TRAFFIC, **(traffic or {})}
    return cell


def test_the_cell_finds_its_files_and_metrics():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == "hstu-ranking")
    assert cfg["source"] == "https://arxiv.org/abs/2402.17152"
    assert cfg["reduced"] == ["item_rows", "table_dtype"]
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.config["model"] == "hstu"
    assert cell.traffic["driver"] == "step"
    assert cell.traffic["batch"] == (cell.traffic["users"]
                                     * cell.traffic["candidates"]) == 2048
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert {m["name"] for m in cell.end_to_end} == {"qps", "batch_p95_ms",
                                                    "setup_s"}
    for name in HSTU_METRICS:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "qps"
    # the published lengths: 256 to 4,096 engagements, log-uniform
    assert model().history_lengths(cell.traffic) == [
        256, 380, 565, 840, 1248, 1855, 2756, 4096]


def test_work_of_a_hand_worked_batch():
    cfg = dict(d_model=4, heads=2, d_qk=2, d_v=3, layers=2, max_seq_len=10,
               time_buckets=3, task_mlp=[5, 1], table_dtype="bfloat16")
    # users of 1 and 3 engagements (2 and 6 tokens), 2 candidates each;
    # items 7 and 9 repeat, actions 1 twice
    batch = model().Batch(
        events=(1, 3), candidates=(2, 2),
        event_offsets=torch.tensor([0, 1, 4], dtype=torch.int32),
        candidate_offsets=torch.tensor([0, 2, 4], dtype=torch.int32),
        item_ids=torch.tensor([7, 9, 7, 3, 9, 4, 5, 6], dtype=torch.int32),
        action_ids=torch.tensor([1, 1, 0, 2], dtype=torch.int32),
        timestamps=torch.zeros(8, dtype=torch.int64))
    inputs = model().Inputs(tables=None, layers=None, head=None,
                            pool=[(batch, None)])
    w = model().work(cfg, inputs, 0)
    # history pairs 2·3/2 + 6·7/2 = 24; candidates 2·3 + 2·7 = 20
    assert w["masked_in_pairs"] == 44
    assert w["tokens"] == 12
    assert w["attn_flops"] == 2 * 2 * 2 * (2 + 3) * 44
    # uvqk width 2 (2·3 + 2·2) = 20; W_o [6, 4]; head 4x5 and 5x1
    products = 2 * 12 * 2 * (4 * 20 + 6 * 4)
    head = 4 * 2 * (4 * 5 + 5 * 1)
    assert w["step_flops"] == w["attn_flops"] + products + head
    # rows {3, 4, 5, 6, 7, 9} and actions {0, 1, 2}, 4 bf16 each
    assert w["distinct_rows"] == 9
    params = 2 * (4 * 20 + 6 * 4 + 4 + 19 + 4) + (4 * 5 + 5 + 5 + 1)
    assert w["step_bytes"] == (9 * 4 * 2 + 12 * 4 + 8 * 8 + params * 4
                               + 4 * 4)
    # the rows, 12 ids, and 12 token rows of 4 f32
    assert w["bag_bytes"] == 9 * 4 * 2 + 12 * 4 + 12 * 4 * 4


def hstu_batch(k, t0, corr):
    """Dispatch k of a traced HSTU forward: the ragged lookup (under
    `bench.ebc`), a layer's product to U, V, Q, K, the attention kernel
    (under `hstu.attention`), the output product, the task MLP's product
    and the logits' copy."""
    def launch(ts, c, name="cudaLaunchKernel"):
        return x("cuda_runtime", name, ts, 1, correlation=c)

    def dev(name, ts, dur, c, cat="kernel"):
        return x(cat, name, ts, dur, tid=DEV, correlation=c)

    return [
        x("user_annotation", f"bench.batch.{k}", t0, 40),
        x("user_annotation", "bench.forward", t0 + 1, 35),
        span("hstu.forward", t0 + 1.5, 34),
        x("user_annotation", "bench.ebc", t0 + 2, 8),
        span("ebc.lookup", t0 + 2.5, 7),
        span("embedding_bag.ragged_launch", t0 + 5, 2),
        launch(t0 + 6, corr),
        x("user_annotation", "bench.encoder", t0 + 11, 16),
        span("hstu.uvqk", t0 + 11.5, 3),
        launch(t0 + 12, corr + 1),
        span("hstu.attention", t0 + 16, 5),
        launch(t0 + 18, corr + 2),
        span("hstu.output", t0 + 22, 4),
        launch(t0 + 23, corr + 3),
        x("user_annotation", "bench.head", t0 + 29, 5),
        span("hstu.head", t0 + 29.5, 4),
        launch(t0 + 30, corr + 4),
        launch(t0 + 38, corr + 5, "cudaMemcpyAsync"),
        dev("void ns::ragged_bag_kernel<__nv_bfloat16, true, 4>(P)",
            t0 + 10, 2, corr),
        dev("sm80_xmma_gemm_f32 uvqk", t0 + 12, 8, corr + 1),
        dev("void ns::hstu_attention_kernel<128>(P)", t0 + 20, 30, corr + 2),
        dev("sm80_xmma_gemm_f32 out", t0 + 50, 4, corr + 3),
        dev("gemv2T_kernel head", t0 + 54, 1, corr + 4),
        dev("Memcpy DtoH (Device -> Pinned)", t0 + 55, 1, corr + 5,
            "gpu_memcpy"),
    ]


def hstu_events(program_spans=True):
    evs = (hstu_batch(4, 0, 10) + hstu_batch(5, 100, 20)
           + hstu_batch(6, 200, 30)
           + [x("user_annotation", "bench.slice", 95, 200)])
    if not program_spans:
        evs = [e for e in evs if not e["name"].startswith("repro_torch.")]
    return evs


def metric_input(readout):
    # per batch, as time at the peak: attn_flops 12 us (the kernel takes
    # 30), the step 40 us, the bags 1 us (the ragged kernel takes 2)
    work = [{"attn_flops": 67e12 * 12e-6, "step_flops": 67e12 * 40e-6,
             "bag_bytes": HBM_BW * 1e-6, "step_bytes": 1.0}] * 2
    return MetricInput(trace=readout, work=work, dispatch_s=[2e-3])


def read(name, m):
    return spec.load_module("metrics", name).read(m)


def test_the_cells_readers_on_a_hand_made_trace():
    r = trace.read(write("hstu", hstu_events()), batches=range(5, 7))
    m = metric_input(r)
    assert read("hstu_attn_ms", m) == pytest.approx(0.030)
    assert read("hstu_attn_roofline", m) == pytest.approx(40.0)
    assert read("embedding_ms", m) == pytest.approx(0.002)
    assert read("step_mfu", m) == pytest.approx(100.0 * 80e-6 / 200e-6)
    # batches 5 and 6 keep the card busy 46 us each of the 200 us slice
    assert read("device_idle", m) == pytest.approx(54.0)
    assert read("dispatch_ms", m) == pytest.approx(2.0)
    # the forward outside bench.ebc: uvqk 8, attention 30, output 4, head 1
    assert read("dense_ms", m) == pytest.approx(0.043)
    assert read("dcn_bag_roofline", m) == pytest.approx(50.0)


def test_a_program_without_hstu_spans_reads_as_none():
    r = trace.read(write("plain", hstu_events(program_spans=False)),
                   batches=range(5, 7))
    m = metric_input(r)
    for name in HSTU_METRICS + ("dcn_bag_roofline",):
        assert read(name, m) is None, name
    assert read("embedding_ms", m) == pytest.approx(0.002)
    r.ops = [op for op in r.ops if "hstu_attention" not in op.name]
    m = metric_input(r)
    assert read("hstu_attn_ms", m) is None


def test_make_inputs_fails_at_once_without_the_program(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "repro_torch.models.hstu"
        else real(name, *a))
    cell = small_cell()
    calls = []
    monkeypatch.setattr(torch, "Generator",
                        lambda *a, **k: calls.append(a) or None)
    with pytest.raises(RuntimeError, match="no repro_torch.models.hstu"):
        model().make_inputs(cell.config, cell.traffic, 1, "cpu")
    assert calls == []           # nothing was drawn


def test_same_seed_same_inputs_and_each_batch_the_same_lengths():
    cell = small_cell()
    a = model().make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    b = model().make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    c = model().make_inputs(cell.config, cell.traffic, 2**31 + 6, "cpu")
    assert torch.equal(a.tables, b.tables)
    assert all(torch.equal(p[0].item_ids, q[0].item_ids)
               and torch.equal(p[0].timestamps, q[0].timestamps)
               for p, q in zip(a.pool, b.pool))
    assert not torch.equal(a.pool[0][0].item_ids, c.pool[0][0].item_ids)
    lengths = sorted(model().history_lengths(cell.traffic))
    for batch, _ in a.pool + c.pool:
        assert sorted(batch.events) == lengths == [4, 8, 16]
        e, n = sum(batch.events), batch.item_ids.numel()
        assert n == e + 12 and batch.action_ids.numel() == e
        assert int(batch.item_ids.max()) < 1000
        assert int(batch.action_ids.max()) < 8
        # each user's times rise, and its candidates share the last
        t0 = 0
        for u, ev in enumerate(batch.events):
            t = batch.timestamps[t0:t0 + ev]
            cand = batch.timestamps[e + 4 * u:e + 4 * (u + 1)]
            assert bool((t[1:] >= t[:-1]).all())
            assert bool((cand == cand[0]).all()) and cand[0] >= t[-1]
            t0 += ev


def test_small_cell_runs_correct_and_the_control_does_not():
    cell = small_cell()
    seed = 2**31 + 41          # holds dispatches 0 and 2: early in any window
    out = run_tiny(cell, seed=seed)
    r = out["result"]
    assert r["correct"] is True, r["check"]
    assert r["failed"] == 0 and r["attempted"] % 12 == 0
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


@pytest.mark.cuda
def test_small_cell_on_the_card(cuda_device):
    """The cell at its published widths with a small item table and short
    histories, traced on the card: correct, one attention launch a layer,
    and every one of its per-layer metrics read, each share within 100 %."""
    from repro_torch.kernels.hstu_attention import kernel
    cell = small_cell(
        config=dict(d_model=512, heads=4, d_qk=128, d_v=128, layers=2,
                    max_seq_len=8448, task_mlp=[512, 256, 1],
                    item_rows=200_000, action_rows=64),
        traffic=dict(users=4, history_min_events=100,
                     history_max_events=1500, candidates=64, batch=256))
    before = kernel.LAUNCHES
    out = run_tiny(cell, seed=2**31 + 21, seconds=1.0, device=cuda_device,
                   trace=True)
    r = out["result"]
    assert r["correct"] is True, r["check"]
    assert kernel.LAUNCHES > before
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(METRICS)
    assert 0 < m["hstu_attn_roofline"] <= 100
    assert 0 < m["step_mfu"] <= 100
    assert 0 <= m["device_idle"] <= 100
    for name in ("hstu_attn_ms", "embedding_ms", "dispatch_ms"):
        assert 0 < m[name], name
