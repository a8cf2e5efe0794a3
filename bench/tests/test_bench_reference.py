"""The plain reference against the port's CPU path, on the benchmark's own
inputs at tiny sizes, and the run of a tiny cell end to end."""
import pytest
import torch

from bench.harness import spec
from bench.reference import dlrm as reference
from bench.tests.conftest import run_tiny, tiny_cell


@pytest.mark.parametrize("traffic", ["med_hot", "random", "high_hot"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_reference_matches_port_cpu_path(traffic, combine):
    cell = tiny_cell(traffic, combine=combine)
    model = spec.load_module("models", "dlrm")
    dev = torch.device("cpu")
    inputs = model.make_inputs(cell.config, cell.traffic, 123, dev)
    program = model.build_program(cell.config, inputs, dev)
    for k in range(len(inputs.pool)):
        dense, idx = inputs.pool[k]
        with torch.inference_mode():
            got_bags = program.ebc(idx)
            got = program(dense, idx)
        bags, logits = model.reference_outputs(cell.config, inputs, k)
        torch.testing.assert_close(got_bags, bags, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got, logits, rtol=1e-5, atol=1e-5)


def test_reference_blocks_agree_with_one_block(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    tables = torch.randn((6, 50, 8), generator=gen)
    idx = torch.randint(0, 50, (9, 6, 5), generator=gen, dtype=torch.int32)
    whole = reference.pooled(tables, idx)
    monkeypatch.setattr(reference, "BLOCK_BYTES", 5 * 8 * 4 * 2)
    torch.testing.assert_close(reference.pooled(tables, idx), whole)
    by_hand = torch.stack([tables[t][idx[:, t].long()].sum(1)
                           for t in range(6)], 1)
    torch.testing.assert_close(whole, by_hand)


def test_interaction_pairs_row_major():
    bottom = torch.tensor([[1.0, 2.0]])
    bags = torch.tensor([[[3.0, 4.0], [5.0, 6.0]]])
    z = reference.interact(bottom, bags)
    # bottom, then <b,e1>, <b,e2>, <e1,e2>
    assert z.tolist() == [[1.0, 2.0, 11.0, 17.0, 39.0]]


def test_tiny_cell_runs_correct_end_to_end():
    out = run_tiny(tiny_cell())
    r = out["result"]
    assert r["correct"] is True and r["failed"] == 0
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "check"]
    assert set(r["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert len(out["side"]["held"]) == 2


def test_same_seed_same_inputs():
    cell = tiny_cell()
    model = spec.load_module("models", "dlrm")
    a = model.make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    b = model.make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    c = model.make_inputs(cell.config, cell.traffic, 2**31 + 6, "cpu")
    assert torch.equal(a.tables, b.tables)
    assert all(torch.equal(x[1], y[1]) for x, y in zip(a.pool, b.pool))
    assert not torch.equal(a.pool[0][1], c.pool[0][1])
