"""The harness on the card at a small size: the CUDA bag kernel on the
timed path, a traced slice read back, and the check. Skips without a card.

    python -m pytest -q bench/tests -m cuda       # on the card's machine
"""
import pytest

from bench.tests.conftest import run_tiny, tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["med_hot", "random"])
def test_small_cell_on_the_card(cuda_device, traffic):
    cell = tiny_cell(traffic, rows=20_000, dim=128, pooling=40,
                     num_tables=16, batch=512, bottom_mlp=[64, 128])
    plain = run_tiny(cell, seed=2**31 + 1, seconds=1.0, device=cuda_device)
    assert plain["result"]["correct"] is True
    assert plain["side"]["bag_launches_per_forward"] == 1.0
    traced = run_tiny(cell, seed=2**31 + 2, seconds=1.0, device=cuda_device,
                      trace=True)
    r = traced["result"]
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0 < m["bag_roofline"] <= 100 and 0 < m["step_mfu"] <= 100
    assert m["embedding_ms"] > 0 and m["dense_ms"] > 0
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"]
