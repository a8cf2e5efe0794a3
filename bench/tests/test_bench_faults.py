"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a tiny size (the look for
a chip is skipped) with one of the faults a DLRM cell can have: half of the
batch left out and the mean of the rest put in its place, an answer
altered where it is produced, a pooled bag altered where the embedding
stage produces it. (A step that returns its state unchanged, and the
exchange between chips, belong to training and to cells on several chips:
these cells have neither.)
"""
import pytest
import torch

from bench.tests.conftest import run_tiny, tiny_cell


def half_batch(forward):
    def broken(self, dense, indices, *a, **k):
        h = dense.shape[0] // 2
        out = forward(self, dense[:h], indices[:h], *a, **k)
        return torch.cat([out, out.mean().expand(dense.shape[0] - h)])
    return broken


def altered_answer(forward):
    def broken(self, dense, indices, *a, **k):
        out = forward(self, dense, indices, *a, **k).clone()
        out[3] += 0.01 * out.abs().max()
        return out
    return broken


def altered_bag(forward):
    def broken(self, indices, *a, **k):
        out = forward(self, indices, *a, **k).clone()
        out[1, 2, 0] += 0.01 * out.abs().max()
        return out
    return broken


@pytest.mark.parametrize("fault,where,number", [
    (half_batch, "dlrm", "logit_gap"),
    (altered_answer, "dlrm", "logit_gap"),
    (altered_bag, "ebc", "pooled_gap"),
])
def test_fault_fails_the_check(monkeypatch, fault, where, number):
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.models.dlrm import DLRM
    cls = DLRM if where == "dlrm" else EmbeddingBagCollection
    monkeypatch.setattr(cls, "forward", fault(cls.forward))
    out = run_tiny(tiny_cell(), seed=11)
    r = out["result"]
    assert r["correct"] is False
    assert r["check"][number]["value"] > r["check"][number]["limit"]


def test_unbroken_run_is_correct():
    assert run_tiny(tiny_cell(), seed=11)["result"]["correct"] is True
