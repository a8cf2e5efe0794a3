"""The HSTU generative-retrieval cell (`bench/models/hstu_retrieval.py`):
its spec and files, its work counts worked by hand, the readers of its two
`mips_*` metrics and of the accepted ones that list the cell on a Chrome
trace made by hand (as `test_bench_spans.py` makes one), a program without
retrieval refused before anything is drawn, and a cut-down cell run end to
end on the CPU against its limits and its control."""
import time

import pytest
import torch

from bench.harness import check, runner, spec, trace
from bench.harness.peaks import HBM_BW
from bench.harness.runner import MetricInput
from bench.tests.conftest import run_tiny
from bench.tests.test_bench_spans import DEV, span, write, x

CELL = "hstu-retrieval.hist_1k"
MIPS_METRICS = ("mips_ms", "mips_roofline")
METRICS = MIPS_METRICS + ("step_mfu", "device_idle", "dispatch_ms",
                          "embedding_ms")
SMALL = dict(d_model=32, heads=2, d_qk=16, d_v=16, layers=2,
             max_seq_len=96, time_buckets=128, retrieve_k=16,
             item_rows=3000, action_rows=8)
SMALL_TRAFFIC = dict(users=3, history_min_events=4, history_max_events=16,
                     batch=48)


def model():
    return spec.load_module("models", "hstu_retrieval")


def small_cell(config=None, traffic=None) -> spec.Cell:
    """The retrieval cell cut to a CPU test's size, held to its limits."""
    cell = spec.load_cell(CELL)
    cell.config = {**cell.config, **SMALL, **(config or {})}
    cell.traffic = {**cell.traffic, **SMALL_TRAFFIC, **(traffic or {})}
    return cell


def test_the_cell_finds_its_files_and_metrics():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == "hstu-retrieval")
    assert cfg["source"] == "https://arxiv.org/abs/2402.17152"
    assert cfg["reduced"] == ["table_dtype"]
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.config["model"] == "hstu_retrieval"
    assert cell.traffic_name == "hist_1k_b16u_k256"
    assert cell.traffic["driver"] == "step"
    assert cell.traffic["batch"] == (cell.traffic["users"]
                                     * cell.config["retrieve_k"]) == 4096
    assert cell.config["task_mlp"] == [] and cell.config["max_seq_len"] == 8192
    # the encoder's widths are the ranking cell's
    ranking = spec.load_cell("hstu-ranking.long_hist").config
    for key in ("d_model", "heads", "d_qk", "d_v", "layers", "time_buckets",
                "item_rows", "action_rows", "table_dtype", "eps"):
        assert cell.config[key] == ranking[key], key
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert {m["name"] for m in cell.end_to_end} == {"qps", "batch_p95_ms",
                                                    "setup_s"}
    for name in MIPS_METRICS:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "qps"
    # the published lengths: 64 to 1,024 engagements, log-uniform
    lengths = spec.load_module("models", "hstu").history_lengths(
        cell.traffic)
    assert lengths[0] == 64 and lengths[-1] == 1024 and len(lengths) == 16
    assert sum(lengths) == 5752


def test_work_of_a_hand_worked_batch():
    cfg = dict(d_model=4, heads=2, d_qk=2, d_v=3, layers=2, max_seq_len=10,
               time_buckets=3, retrieve_k=5, item_rows=100,
               table_dtype="bfloat16")
    # users of 1 and 3 engagements (2 and 6 tokens), no candidates;
    # actions 1 twice
    batch = spec.load_module("models", "hstu").Batch(
        events=(1, 3), candidates=(0, 0),
        event_offsets=torch.tensor([0, 1, 4], dtype=torch.int32),
        candidate_offsets=torch.zeros(3, dtype=torch.int32),
        item_ids=torch.tensor([7, 9, 7, 3], dtype=torch.int32),
        action_ids=torch.tensor([1, 1, 0, 2], dtype=torch.int32),
        timestamps=torch.zeros(4, dtype=torch.int64))
    inputs = spec.load_module("models", "hstu").Inputs(
        tables=None, layers=None, head=None, pool=[(batch, None)])
    w = model().work(cfg, inputs, 0)
    # history pairs 2·3/2 + 6·7/2 = 24
    assert w["masked_in_pairs"] == 24 and w["tokens"] == 8
    assert w["attn_flops"] == 2 * 2 * 2 * (2 + 3) * 24
    # uvqk width 2 (2·3 + 2·2) = 20; W_o [6, 4]; every row of 100 against
    # 2 queries
    products = 2 * 8 * 2 * (4 * 20 + 6 * 4)
    assert w["mips_flops"] == 2 * 2 * 100 * 4
    assert w["step_flops"] == w["attn_flops"] + products + w["mips_flops"]
    # 100 item rows of 4 bf16; the queries (2 x 4 f32) read, 2 x 5 ids and
    # scores written
    outputs = 2 * 4 * 4 + 2 * 5 * 8
    assert w["mips_bytes"] == 100 * 4 * 2 + outputs
    params = 2 * (4 * 20 + 6 * 4 + 4 + 19 + 4)
    # actions {0, 1, 2}; 8 ids and 4 timestamps
    assert w["step_bytes"] == ((100 + 3) * 4 * 2 + 8 * 4 + 4 * 8
                               + params * 4 + outputs)


def retrieval_batch(k, t0, corr):
    """Dispatch k of a traced retrieval: the ragged lookup (under
    `bench.ebc`), the attention kernel (under `hstu.attention`), the
    query's norm (under `hstu.query`), the scan and the merge (under
    `hstu.mips`), the benchmark's rescoring and the scores' copy."""
    def launch(ts, c, name="cudaLaunchKernel"):
        return x("cuda_runtime", name, ts, 1, correlation=c)

    def dev(name, ts, dur, c, cat="kernel"):
        return x(cat, name, ts, dur, tid=DEV, correlation=c)

    return [
        x("user_annotation", f"bench.batch.{k}", t0, 45),
        x("user_annotation", "bench.forward", t0 + 1, 40),
        span("hstu.retrieve", t0 + 1.5, 30),
        x("user_annotation", "bench.ebc", t0 + 2, 8),
        span("ebc.lookup", t0 + 2.5, 7),
        span("embedding_bag.ragged_launch", t0 + 5, 2),
        launch(t0 + 6, corr),
        x("user_annotation", "bench.encoder", t0 + 11, 10),
        span("hstu.attention", t0 + 12, 5),
        launch(t0 + 14, corr + 1),
        span("hstu.query", t0 + 22, 3),
        launch(t0 + 23, corr + 2),
        span("hstu.mips", t0 + 26, 5),
        launch(t0 + 27, corr + 3),
        launch(t0 + 29, corr + 4),
        launch(t0 + 34, corr + 5),
        launch(t0 + 38, corr + 6, "cudaMemcpyAsync"),
        dev("void ns::ragged_bag_kernel<__nv_bfloat16, true, 4>(P)",
            t0 + 10, 2, corr),
        dev("void ns::hstu_attention_kernel<128>(P)", t0 + 14, 10, corr + 1),
        dev("void at::native::reduce_kernel norm", t0 + 24, 1, corr + 2),
        dev("void ns::mips_scan_kernel<16>(P)", t0 + 27, 24, corr + 3),
        dev("void ns::mips_merge_kernel(P)", t0 + 51, 6, corr + 4),
        dev("sm80_xmma_gemm_f32 rescore", t0 + 57, 1, corr + 5),
        dev("Memcpy DtoH (Device -> Pinned)", t0 + 58, 1, corr + 6,
            "gpu_memcpy"),
    ]


def retrieval_events(program_spans=True):
    evs = (retrieval_batch(4, 0, 10) + retrieval_batch(5, 100, 20)
           + retrieval_batch(6, 200, 30)
           + [x("user_annotation", "bench.slice", 95, 200)])
    if not program_spans:
        evs = [e for e in evs if not e["name"].startswith("repro_torch.")]
    return evs


def metric_input(readout):
    # per batch, as time at the peak: the rows 15 us (the scan and the
    # merge take 30), the attention 5 us (its kernel takes 10), the step
    # 40 us
    work = [{"mips_bytes": HBM_BW * 15e-6, "attn_flops": 67e12 * 5e-6,
             "step_flops": 67e12 * 40e-6, "step_bytes": 1.0}] * 2
    return MetricInput(trace=readout, work=work, dispatch_s=[3e-3])


def read(name, m):
    return spec.load_module("metrics", name).read(m)


def test_the_cells_readers_on_a_hand_made_trace():
    r = trace.read(write("retrieval", retrieval_events()),
                   batches=range(5, 7))
    m = metric_input(r)
    assert read("mips_ms", m) == pytest.approx(0.030)
    assert read("mips_roofline", m) == pytest.approx(50.0)
    assert read("hstu_attn_ms", m) == pytest.approx(0.010)
    assert read("hstu_attn_roofline", m) == pytest.approx(50.0)
    assert read("embedding_ms", m) == pytest.approx(0.002)
    assert read("step_mfu", m) == pytest.approx(100.0 * 80e-6 / 200e-6)
    # batches 5 and 6 keep the card busy 45 us each of the 200 us slice
    # (2 + 11 + 32: the attention's end meets the norm, the scan's start
    # waits 2 us, then the merge, the rescoring and the copy meet)
    assert read("device_idle", m) == pytest.approx(55.0)
    assert read("dispatch_ms", m) == pytest.approx(3.0)


def test_a_program_without_the_spans_reads_as_none():
    """The parent's program, or any without `hstu.mips`: both readers
    return nothing and raise nothing."""
    r = trace.read(write("plain", retrieval_events(program_spans=False)),
                   batches=range(5, 7))
    m = metric_input(r)
    for name in MIPS_METRICS:
        assert read(name, m) is None, name
    assert read("embedding_ms", m) == pytest.approx(0.002)


def test_make_inputs_fails_at_once_without_retrieval(monkeypatch):
    from repro_torch.models.hstu import HSTU
    monkeypatch.delattr(HSTU, "retrieve")
    cell = small_cell()
    calls = []
    monkeypatch.setattr(torch, "Generator",
                        lambda *a, **k: calls.append(a) or None)
    with pytest.raises(RuntimeError, match="no HSTU.retrieve"):
        model().make_inputs(cell.config, cell.traffic, 1, "cpu")
    assert calls == []           # nothing was drawn


def test_same_seed_same_inputs_and_histories_alone():
    cell = small_cell()
    a = model().make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    b = model().make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    c = model().make_inputs(cell.config, cell.traffic, 2**31 + 6, "cpu")
    assert torch.equal(a.tables, b.tables) and a.head == []
    assert all(torch.equal(p[0].item_ids, q[0].item_ids)
               and torch.equal(p[0].timestamps, q[0].timestamps)
               for p, q in zip(a.pool, b.pool))
    assert not torch.equal(a.pool[0][0].item_ids, c.pool[0][0].item_ids)
    for batch, _ in a.pool + c.pool:
        assert sorted(batch.events) == [4, 8, 16]
        e = sum(batch.events)
        assert batch.candidates == (0, 0, 0)
        assert batch.candidate_offsets.tolist() == [0, 0, 0, 0]
        assert batch.item_ids.numel() == batch.action_ids.numel() == e
        assert batch.timestamps.numel() == e
        assert int(batch.item_ids.max()) < 3000


def test_small_cell_runs_correct_and_the_control_does_not():
    cell = small_cell()
    seed = 2**31 + 41          # holds dispatches 0 and 2: early in any window
    out = run_tiny(cell, seed=seed)
    r = out["result"]
    assert r["correct"] is True, r["check"]
    assert r["failed"] == 0 and r["attempted"] % 48 == 0
    assert set(r["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    mod, inputs, window, _ = runner.open_window(
        cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter())
    ref = runner.reference_outputs(mod, cell.config, inputs, window)
    # each window batch's 48 numbers are its users' 16 best scores, best
    # first, as the reference has them
    for k, got in zip(window.pool_index, window.logits):
        want = ref[k][1].numpy()
        assert got.shape == (48,)
        assert abs(got - want).max() <= 1e-6 * abs(want).max()
    ctl = runner.reference_outputs(mod, cell.config, inputs, window,
                                   lower=True)
    values = check.readings(check.control_window(window, ctl), ref)
    ok, _ = check.judge(values, cell.limits)
    assert not ok
    assert values["pooled_gap"] > 20 * cell.limits["pooled_gap"]["limit"]
    assert values["logit_gap"] > cell.limits["logit_gap"]["limit"]
