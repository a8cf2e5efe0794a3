"""The byte and FLOP counts behind bag_roofline and step_mfu, on a batch
worked by hand."""
import pytest
import torch

from bench.harness import peaks, spec


def test_work_of_a_hand_worked_batch():
    model = spec.load_module("models", "dlrm")
    cfg = dict(model="dlrm", dense_features=3, bottom_mlp=[4, 2],
               top_mlp=[5, 1], interaction="dot", dtype="float32",
               num_tables=2, rows=10, dim=2, pooling=3, combine="sum",
               storage="device", shard_pad_tables=0)
    # B=2, T=2, L=3: table 0 reads rows {1, 2}, table 1 rows {1, 7, 9}
    idx = torch.tensor([[[1, 1, 2], [7, 7, 7]],
                        [[2, 1, 1], [1, 9, 7]]], dtype=torch.int32)
    dense = torch.zeros((2, 3))
    inputs = model.Inputs(tables=None, bottom=None, top=None,
                          pool=[(dense, idx)])
    w = model.work(cfg, inputs, 0)
    assert w["distinct_rows"] == 5
    rows, index, pooled = 5 * 2 * 4, 12 * 4, 2 * 2 * 2 * 4
    assert w["bag_bytes"] == rows + index + pooled
    # weights: bottom 3x4+4, 4x2+2; top: (2 + 3*2/2 = 5)x5+5, 5x1+1
    weights = (16 + 10 + 30 + 6) * 4
    assert w["step_bytes"] == rows + index + 2 * 3 * 4 + weights + 2 * 4
    mlp = 2 * 2 * (3 * 4 + 4 * 2 + 5 * 5 + 5 * 1)
    pool = 2 * 2 * (3 - 1) * 2
    inter = 2 * 3 * (2 * 2 - 1)
    assert w["step_flops"] == mlp + pool + inter


def test_least_seconds_takes_the_larger_term():
    assert peaks.least_seconds(67e12, 0) == 1.0
    assert peaks.least_seconds(0, 3.35e12) == 1.0
    assert peaks.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
