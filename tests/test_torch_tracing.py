"""The port's spans (`repro_torch.tracing.span`) in a profiled DLRM forward
on the CPU: which ranges the Chrome trace holds and how they nest, that
no span reaches `record_function` while no profiler runs, and that
profiling leaves the logits bit for bit as they were.

On the CPU the embedding stage takes the plain gather, so the bag kernel's
span (`embedding_bag.launch`) opens only on the card, where the benchmark's
tests trace it (`bench/tests/test_bench_spans.py`, marked `cuda`)."""
import json

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.kernels.embedding_bag import kernel
from repro_torch.models import DLRM, DLRMConfig

TABLES, ROWS, DIM, POOL, BATCH = 4, 500, 16, 6, 9
LAYERS = ("dlrm.forward", "ebc.lookup", "dlrm.bottom", "dlrm.interact",
          "dlrm.top")


def _model(interaction="dot"):
    cfg = DLRMConfig(
        dense_features=5, bottom_mlp=(32, DIM), top_mlp=(32, 16, 1),
        interaction=interaction,
        embedding=EmbeddingStageConfig(num_tables=TABLES, rows=ROWS,
                                       dim=DIM, pooling=POOL))
    return DLRM(cfg, device="cpu", seed=3)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    dense = torch.from_numpy(rng.normal(size=(BATCH, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(
        0, ROWS, size=(BATCH, TABLES, POOL)).astype(np.int32))
    return dense, idx


def _profiled(fn, path):
    """Run `fn` under a CPU profiler; (its result, the trace's complete
    host events)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    return out, events


def _spans(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"
            and e["name"] == tracing.PREFIX + name]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("interaction", ["dot", "cat"])
def test_spans_nest_once_a_forward(tmp_path, interaction):
    model, (dense, idx) = _model(interaction), _batch()

    def two_forwards():
        with torch.inference_mode():
            return [model(dense, idx) for _ in range(2)]

    _, events = _profiled(two_forwards, tmp_path / "t.json")
    found = {name: _spans(events, name) for name in LAYERS}
    assert {n: len(s) for n, s in found.items()} == dict.fromkeys(LAYERS, 2)
    assert _spans(events, "embedding_bag.launch") == []
    for k, fwd in enumerate(sorted(found["dlrm.forward"])):
        mine = {n: sorted(found[n])[k] for n in LAYERS[1:]}
        assert all(_inside(s, fwd) for s in mine.values())
        # the stages run one after another, each closed before the next
        order = [mine[n] for n in LAYERS[1:]]
        assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    bmm = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "cpu_op" and e["name"] == "aten::bmm"]
    assert len(bmm) == (2 if interaction == "dot" else 0)
    assert all(any(_inside(b, s) for s in found["dlrm.interact"])
               for b in bmm)
    # each tower's products fall under its own span
    for tower in ("dlrm.bottom", "dlrm.top"):
        mms = [e for e in events if e.get("cat") == "cpu_op"
               and e["name"] in ("aten::mm", "aten::matmul")
               and any(_inside((e["ts"], e["ts"] + e["dur"]), s)
                       for s in found[tower])]
        assert mms


def test_launch_span_encloses_the_checks(tmp_path):
    """The bag kernel's span opens before its checks: a call the checks
    refuse (tables on the CPU) still leaves one range in the trace."""
    tables = torch.zeros(2, 8, 4)
    idx = torch.zeros(3, 2, 5, dtype=torch.int32)

    def refused():
        with pytest.raises(ValueError, match="CUDA"):
            kernel.embedding_bag_cuda(tables, idx)

    _, events = _profiled(refused, tmp_path / "t.json")
    assert len(_spans(events, "embedding_bag.launch")) == 1


def test_no_record_function_without_a_profiler(tmp_path, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    model, (dense, idx) = _model(), _batch()
    with torch.inference_mode():
        model(dense, idx)
    assert calls == []
    assert tracing.span("a") is tracing.span("b")
    # the same patched function is what a profiled forward reaches
    with torch.inference_mode():
        _profiled(lambda: model(dense, idx), tmp_path / "t.json")
    assert sorted(calls) == sorted(tracing.PREFIX + n for n in LAYERS)


@pytest.mark.parametrize("interaction", ["dot", "cat"])
def test_profiling_leaves_logits_bitwise_equal(tmp_path, interaction):
    model, (dense, idx) = _model(interaction), _batch(seed=5)
    with torch.inference_mode():
        plain = model(dense, idx)
        traced, _ = _profiled(lambda: model(dense, idx), tmp_path / "t.json")
    assert torch.equal(plain, traced)
    assert plain.dtype == torch.float32 and plain.shape == (BATCH,)
