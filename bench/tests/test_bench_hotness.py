"""The torch hotness sampler against the frozen Table III calibration."""
import pytest
import torch

from bench.harness import hotness, spec

TRAFFIC = ["med_hot", "high_hot", "random", "random_b16k"]


@pytest.mark.parametrize("name", TRAFFIC)
def test_traffic_alpha_is_the_calibration(name):
    t = spec.load_json(spec.BENCH / "traffic" / f"{name}.json")
    if t["hotness"] == "random":
        assert t["zipf_alpha"] == 0.0
    else:
        assert t["zipf_alpha"] == hotness.calibrate_alpha(
            hotness.PAPER_UNIQUE_PCT[t["hotness"]])
        assert hotness.expected_unique_pct(
            hotness.REF_ROWS, t["zipf_alpha"],
            hotness.REF_ACCESSES) == pytest.approx(t["table3_unique_pct"],
                                                   rel=1e-6)


@pytest.mark.parametrize("name", ["med_hot", "high_hot", "random"])
def test_sampled_distinct_share_matches_expected(name):
    """At the reference workload (500,000 rows, 2048 x 150 lookups a
    table) each table's distinct share lies within 1 % of the expected."""
    t = spec.load_json(spec.BENCH / "traffic" / f"{name}.json")
    gen = torch.Generator().manual_seed(3)
    s = hotness.HotnessSampler(tables=3, rows=hotness.REF_ROWS,
                               alpha=t["zipf_alpha"], generator=gen)
    idx = s.sample(2048, 150)
    assert idx.dtype == torch.int32 and idx.shape == (2048, 3, 150)
    assert int(idx.min()) >= 0 and int(idx.max()) < hotness.REF_ROWS
    want = hotness.expected_unique_pct(hotness.REF_ROWS, t["zipf_alpha"],
                                       hotness.REF_ACCESSES)
    for table in range(3):
        got = hotness.distinct_rows(idx[:, table:table + 1],
                                    hotness.REF_ROWS)
        assert got * 100.0 / hotness.REF_ROWS == pytest.approx(want, rel=0.01)
    assert hotness.distinct_rows(idx, hotness.REF_ROWS) == sum(
        hotness.distinct_rows(idx[:, t:t + 1], hotness.REF_ROWS)
        for t in range(3))


def test_tables_scatter_their_hot_rows_differently():
    gen = torch.Generator().manual_seed(0)
    s = hotness.HotnessSampler(tables=2, rows=1000, alpha=1.2, generator=gen)
    idx = s.sample(256, 20)
    top = [torch.mode(idx[:, t].flatten()).values.item() for t in range(2)]
    assert top[0] == s.perms[0, 0].item() and top[1] == s.perms[1, 0].item()
    assert top[0] != top[1]
