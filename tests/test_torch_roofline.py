"""The port's roofline (`repro_torch.roofline`) on the CPU, mirroring
tests/test_roofline.py: `OpCost` counts what a call dispatches (on meta
tensors at full width), `roofline_terms` divides by the H100's constants.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.roofline.analyze import HloCost
from repro.roofline.analyze import roofline_terms as jax_roofline_terms
from repro_torch.configs import get_config, reduced
from repro_torch.models import abstract_params
from repro_torch.roofline import hw, report
from repro_torch.roofline.analyze import OpCost, roofline_terms

META = torch.device("meta")


def _cost(fn, *args) -> dict:
    with OpCost() as cost:
        fn(*args)
    return cost.total()


def test_flops_simple_matmul():
    a = torch.zeros((128, 256), device=META)
    b = torch.zeros((256, 64), device=META)
    assert _cost(torch.matmul, a, b)["flops"] == 2 * 128 * 256 * 64


@pytest.mark.parametrize("eq,shapes,want", [
    ("bmk,bkn->bmn", [(4, 8, 16), (4, 16, 32)], 2 * 4 * 8 * 16 * 32),
    ("bqkgh,bskh->bqkgs", [(2, 5, 2, 3, 16), (2, 7, 2, 16)],
     2 * 2 * 2 * (5 * 3) * 7 * 16),
    ("ecd,edf->ecf", [(8, 4, 32), (8, 32, 64)], 2 * 8 * 4 * 32 * 64),
])
def test_flops_einsum_decomposes_to_bmm(eq, shapes, want):
    args = [torch.zeros(s, device=META) for s in shapes]
    assert _cost(lambda: torch.einsum(eq, *args))["flops"] == want


def test_flops_scale_with_trip_count():
    """A loop of 16 layers counts 16 times one layer: there is no scan to
    unroll, every launch is seen."""
    w = torch.zeros((16, 64, 64), device=META)
    x = torch.zeros((8, 64), device=META)

    def layers(n):
        h = x
        for i in range(n):
            h = torch.tanh(h @ w[i])
        return h
    one = _cost(layers, 1)["flops"]
    assert one == 2 * 8 * 64 * 64
    assert _cost(layers, 16)["flops"] == 16 * one


def test_model_flops_scale_with_layers():
    """Each added phi4-mini layer (reduced widths) adds the same flops."""
    def flops(layers):
        model, _ = abstract_params(reduced(get_config("phi4-mini-3.8b"),
                                           layers=layers))
        toks = torch.zeros((2, 32), dtype=torch.long, device=META)
        return _cost(model, toks)["flops"]
    f2, f4, f6 = flops(2), flops(4), flops(6)
    assert f6 - f4 == f4 - f2 > 0


def test_bytes_reasonable_for_copy_free_reduction():
    x = torch.zeros((1024, 1024), dtype=torch.float32, device=META)  # 4 MiB
    by = _cost(torch.sum, x)["bytes"]
    assert 4e6 * 0.5 < by < 4e6 * 4  # ~one read of the input


@pytest.mark.parametrize("write", ["slice_copy", "index_put", "index_copy"])
def test_inplace_write_charged_as_update_region(write):
    """A cache write into a slice or by index is charged the region, not
    the buffer (the HLO parser's dynamic-update-slice rule)."""
    buf = torch.zeros((1024, 1024), dtype=torch.float32, device=META)
    upd = torch.ones((1, 1024), dtype=torch.float32, device=META)
    idx = torch.zeros((1,), dtype=torch.long, device=META)

    def fn():
        if write == "slice_copy":
            buf[5:6] = upd
        elif write == "index_put":
            buf.index_put_((idx,), upd, accumulate=True)
        else:
            buf.index_copy_(0, idx, upd)
    by = _cost(fn)["bytes"]
    assert 0 < by < 1024 * 1024 * 4 * 0.5, by  # NOT the whole buffer
    assert by >= 2 * 1024 * 4                     # the row read and written


def test_kv_cache_write_is_a_slice_of_the_cache():
    """A decode step of phi4-mini at full width writes one position of its
    cache a layer: the step's bytes grow by far less than the cache when
    the cache grows."""
    model, _ = abstract_params(get_config("phi4-mini-3.8b"))
    tok = torch.zeros((1, 1), dtype=torch.long, device=META)

    def step_bytes(s_max):
        cache = model.init_cache(1, s_max)
        with OpCost() as cost:
            model.decode_step(tok, cache, 7)
        return cost.total()["bytes"], cost.bytes_by_op.get("copy_", 0.0)
    small, copy_small = step_bytes(64)
    big, copy_big = step_bytes(4096)
    assert copy_small == copy_big > 0       # the written region only
    per_pos = 2 * 32 * 8 * 128 * 2          # k+v, 32 layers, bf16
    # attention still reads (and widens to f32) the whole cache
    assert big - small < (4096 - 64) * per_pos * 6


def test_gather_charged_its_rows():
    table = torch.zeros((200_064, 3072), dtype=torch.bfloat16, device=META)
    idx = torch.zeros((8, 1), dtype=torch.long, device=META)
    by = _cost(lambda: table[idx])["bytes"]
    assert by == 8 * 8 + 2 * 8 * 3072 * 2


def test_decode_step_bytes_and_flops_at_full_width():
    """phi4-mini, bf16, batch 1: a decode step moves at least every weight
    once (the floor) and does ~2 flops a parameter."""
    cfg = get_config("phi4-mini-3.8b")
    model, params = abstract_params(cfg)
    weights = sum(p.numel() * p.element_size() for p in params.values())
    cache = model.init_cache(1, 576)
    with OpCost() as cost:
        model.decode_step(torch.zeros((1, 1), dtype=torch.long, device=META),
                          cache, 512)
    t = cost.total()
    assert weights <= t["bytes"] < 1.2 * weights
    n = sum(p.numel() for p in params.values())
    assert 2 * (n - cfg.vocab_size * cfg.d_model) <= t["flops"] < 2.1 * n
    assert t["collective_bytes"] == 0


def test_collectives_counted(tmp_path):
    """A world-size-1 gloo all_reduce through the functional collectives is
    counted at its operand bytes."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        x = torch.ones((1024, 64), dtype=torch.float32)
        with OpCost() as cost:
            y = funcol.wait_tensor(funcol.all_reduce(x, "sum",
                                                     dist.group.WORLD))
        assert torch.equal(y, x)
    finally:
        dist.destroy_process_group()
    t = cost.total()
    assert t["collective_bytes"] == 1024 * 64 * 4, t
    assert t["collective_breakdown"] == {"all_reduce": 1024 * 64 * 4}


def test_roofline_terms_shape():
    a = torch.zeros((256, 256), device=META)
    t = roofline_terms(_cost(torch.matmul, a, a), num_chips=4)
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["compute_s"] == pytest.approx(
        t["per_device_flops"] / hw.PEAK_FLOPS_BF16)
    assert t["memory_s"] == pytest.approx(t["per_device_bytes"] / hw.HBM_BW)
    hlo = jax.jit(lambda x: x @ x).lower(jnp.zeros((256, 256))).compile()
    assert set(t) == set(jax_roofline_terms(hlo.as_text(), num_chips=4))


def test_reduced_phi4_forward_flops_match_hlocost():
    """The flops of a reduced phi4-mini forward, counted op by op here and
    from the jitted JAX forward's HLO there, agree within 5 % (the matrix
    products are the same ones: both count 2*M*N*K a dot)."""
    B, S = 2, 32
    jmodel = jax_build_model(jax_reduced(jax_get_config("phi4-mini-3.8b")))
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    hlo = jax.jit(jmodel.forward).lower(
        params, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile().as_text()
    want = HloCost(hlo).total()["flops"]
    model, _ = abstract_params(reduced(get_config("phi4-mini-3.8b")))
    got = _cost(model, torch.zeros((B, S), dtype=torch.long,
                                   device=META))["flops"]
    assert abs(got - want) / want < 0.05, (got, want)


def test_hw_constants_are_the_h100s():
    """NVIDIA's H100 SXM5 80 GB data sheet (dense rates)."""
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.PEAK_FLOPS_F32 == 67e12
    assert hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80e9
    assert hw.NVLINK_BW == 900e9
    assert hw.L2_BYTES == 50 * 2**20
    assert hw.NUM_SMS == 132
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.int64,
               torch.bool, torch.float8_e4m3fn):
        name = str(dt).removeprefix("torch.")
        assert hw.DTYPE_BYTES[name] == torch.empty((), dtype=dt).element_size()


def test_report_renders_records(tmp_path, capsys):
    cost = {"flops": 7.7e9, "bytes": 8.1e9, "collective_bytes": 0.0,
            "collective_breakdown": {}}
    rec = {"arch": "phi4-mini-3.8b", "shape": "decode_b1", "mesh": "single",
           "cell": "phi4-mini-3.8b__decode_b1__single", "status": "ok",
           "roofline": roofline_terms(cost, num_chips=1),
           "memory": {"per_device_total": 8.0e9},
           "model_flops_global": 7.7e9, "floor_ms": 2.29,
           "measured_ms": 9.5, "device": "a card, 700 W"}
    (tmp_path / "a.json").write_text(json.dumps(rec))
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| phi4-mini-3.8b | decode_b1 | single |" in out
    assert "| memory |" in out and "| 2.290 | 9.500 |" in out
    assert "measured on: a card, 700 W" in out
    assert "furthest from its floor: phi4-mini-3.8b__decode_b1__single" in out
    assert report.mfu_proxy(rec) == pytest.approx(
        7.7e9 / (hw.PEAK_FLOPS_BF16 * 8.1e9 / hw.HBM_BW))
