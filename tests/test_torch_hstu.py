"""HSTU generative ranking in the port, on the CPU at a small size: the
jagged batch, the embedding stage on two tables with bags of one row, the
encoder's layers with the plain attention (`kernels/hstu_attention/ref.py`)
and the task MLP, against the plain reference `tests/_reference_hstu.py`
on seeded weights.

On the CPU the attention is the plain version; the CUDA kernel
(`csrc/hstu_attention.cu`) is held to it on the card by `chip_smoke.py`'s
`hstu` phase and by the benchmark's `hstu-ranking.long_hist` cell."""
import dataclasses
import math

import pytest
import torch

import _reference_hstu as reference
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels.hstu_attention import (JaggedLayout,
                                                bucket_thresholds,
                                                hstu_attention,
                                                hstu_attention_cuda,
                                                hstu_attention_ref,
                                                time_bucket)
from repro_torch.kernels.hstu_attention.ref import (attention_mask,
                                                    time_bucket_of)
from repro_torch.models.hstu import HSTU, HSTUConfig, JaggedBatch

SMALL = HSTUConfig(d_model=32, heads=2, d_qk=16, d_v=16, layers=2,
                   max_seq_len=96, time_buckets=128, task_mlp=(16, 8, 1),
                   item_rows=1000, action_rows=1000, table_dtype="float32",
                   eps=1e-6)
EVENTS = (1, 3, 17, 40)
CANDIDATES = 5

# Tolerances, as a gap over the largest reference entry. Both sides are
# f32 with the same operations; the program runs the products over every
# row of the batch at once and the reference over one user's rows, so the
# two may round differently in the last place of each product (sums of at
# most 96 terms), and a layer's LayerNorms and residual carry that along.
# Two layers of such roundings stay well under 1e-5 of the largest state;
# a bf16 rounding of the states (2**-9) would break it 400-fold.
STATE_TOL = 1e-5
LOGIT_TOL = 1e-5


def ref_cfg(cfg: HSTUConfig) -> dict:
    return {"heads": cfg.heads, "d_qk": cfg.d_qk, "d_v": cfg.d_v,
            "max_seq_len": cfg.max_seq_len, "time_buckets": cfg.time_buckets,
            "eps": cfg.eps, "item_rows": cfg.item_rows}


def make_model(cfg: HSTUConfig = SMALL, seed: int = 0) -> HSTU:
    """The model on seeded weights, its zero-initialised biases drawn
    N(0, 0.05) so that the comparison sees them."""
    model = HSTU(cfg, device="cpu", seed=seed).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("b_o") or name.startswith("head.b"):
                p.normal_(0.0, 0.05, generator=gen)
    return model


def weights(model: HSTU):
    layers = [{name: getattr(layer, name) for name in
               ("w_uvqk", "w_o", "b_o", "pos_bias", "time_bias")}
              for layer in model.encoder.layers]
    head = [(getattr(model.head, f"w{i}"), getattr(model.head, f"b{i}"))
            for i in range(model.head.num_layers)]
    return layers, head


def make_batch(events=EVENTS, candidates=CANDIDATES, cfg=SMALL,
               seed=0) -> JaggedBatch:
    """Ids drawn uniform; times per user from 1.7e9 s, exponential gaps of
    a mean of 3,600 s, the candidates one more gap after the last event."""
    gen = torch.Generator().manual_seed(seed)
    cands = (candidates,) * len(events) if isinstance(candidates, int) \
        else tuple(candidates)
    num_e, num_c = sum(events), sum(cands)
    ev_times, cand_times = [], []
    for e, m in zip(events, cands):
        gaps = torch.empty(e + 1).exponential_(1 / 3600.0, generator=gen)
        t = 1_700_000_000 + gaps.cumsum(0).long()
        ev_times.append(t[:e])
        cand_times.append(t[e:].expand(m))
    return JaggedBatch(
        events=tuple(events), candidates=cands,
        event_offsets=torch.tensor([0, *torch.tensor(events).cumsum(0)],
                                   dtype=torch.int32),
        candidate_offsets=torch.tensor([0, *torch.tensor(cands).cumsum(0)],
                                       dtype=torch.int32),
        item_ids=torch.randint(0, cfg.item_rows, (num_e + num_c,),
                               generator=gen, dtype=torch.int32),
        action_ids=torch.randint(0, cfg.action_rows, (num_e,),
                                 generator=gen, dtype=torch.int32),
        timestamps=torch.cat(ev_times + cand_times))


def reference_of(model: HSTU, batch: JaggedBatch):
    layers, head = weights(model)
    with torch.no_grad():
        return reference.forward(model.ebc.tables, layers, head,
                                 ref_cfg(model.cfg), batch.events,
                                 batch.candidates, batch.item_ids,
                                 batch.action_ids, batch.timestamps)


def gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_jagged_lengths_match_the_reference():
    model = make_model()
    batch = make_batch()
    with torch.inference_mode():
        x = model.embed(batch)
        states = model.encoder(x, batch.layout(), torch.cat([
            batch.timestamps[:sum(EVENTS)].repeat_interleave(2),
            batch.timestamps[sum(EVENTS):]]))
        logits = model(batch)
    want_states, want_logits = reference_of(model, batch)
    assert states.shape == (2 * sum(EVENTS) + 4 * CANDIDATES, 32)
    assert logits.shape == (4 * CANDIDATES,)
    assert gap(states, want_states) <= STATE_TOL
    assert gap(logits, want_logits) <= LOGIT_TOL
    # the counters: token rows and masked-in pairs a head, this forward
    assert model.tokens == 2 * sum(EVENTS) + 4 * CANDIDATES
    assert model.pairs == sum(2 * e * (2 * e + 1) // 2
                              + CANDIDATES * (2 * e + 1) for e in EVENTS)


def test_a_users_logits_do_not_depend_on_the_batch():
    model = make_model()
    batch = make_batch()
    with torch.inference_mode():
        together = model(batch)
        for u, e in enumerate(EVENTS):
            lo, hi = sum(EVENTS[:u]), sum(EVENTS[:u + 1])
            c_lo = sum(EVENTS) + u * CANDIDATES
            alone = JaggedBatch(
                events=(e,), candidates=(CANDIDATES,),
                event_offsets=torch.tensor([0, e], dtype=torch.int32),
                candidate_offsets=torch.tensor([0, CANDIDATES],
                                               dtype=torch.int32),
                item_ids=torch.cat([batch.item_ids[lo:hi],
                                    batch.item_ids[c_lo:c_lo + CANDIDATES]]),
                action_ids=batch.action_ids[lo:hi],
                timestamps=torch.cat([
                    batch.timestamps[lo:hi],
                    batch.timestamps[c_lo:c_lo + CANDIDATES]]))
            got = model(alone)
            # 1/N is the configured N, not the batch's longest: only the
            # products' rounding over other rows can move a logit
            torch.testing.assert_close(
                got, together[u * CANDIDATES:(u + 1) * CANDIDATES],
                rtol=1e-6, atol=1e-6)


def test_changing_one_candidate_leaves_the_others_bit_identical():
    model = make_model()
    batch = make_batch()
    changed = sum(EVENTS) + 2 * CANDIDATES + 3     # user 2's fourth
    items = batch.item_ids.clone()
    items[changed] = (items[changed] + 1) % SMALL.item_rows
    times = batch.timestamps.clone()
    times[changed] += 86_400
    other = dataclasses.replace(batch, item_ids=items, timestamps=times)
    with torch.inference_mode():
        a, b = model(batch), model(other)
    keep = torch.ones_like(a, dtype=torch.bool)
    keep[2 * CANDIDATES + 3] = False
    assert torch.equal(a[keep], b[keep])
    assert not torch.equal(a[~keep], b[~keep])


def test_time_buckets_at_their_edges():
    buckets = SMALL.time_buckets
    th = torch.tensor(bucket_thresholds(buckets))
    e = math.exp(0.301)
    # |dt| of 0 and 1 both give ln 1 = 0; e^0.301 is the first edge
    assert time_bucket_of(0, buckets) == time_bucket_of(1, buckets) == 0
    assert time_bucket_of(e * (1 + 1e-12), buckets) == 1
    assert time_bucket_of(e * (1 - 1e-12), buckets) == 0
    # integer |dt|: 1 -> 0, 2 -> floor(ln 2 / 0.301) = 2: bucket 1 is empty
    assert th[:4].tolist() == [0, 2, 2, 3]
    assert time_bucket(torch.tensor([0, 1, 2, 3]), th).tolist() == [0, 0, 2,
                                                                     3]
    # the clamp: ln(2**62) / 0.301 = 142.8
    big = torch.tensor([2 ** 62, 2 ** 40])
    assert time_bucket(big, th).tolist() == [buckets, 92]
    assert reference.time_bucket(big, buckets).tolist() == [buckets, 92]
    # the thresholds put every integer where the double-precision formula
    # does: all |dt| to 2e5 s, and a sweep to 2**45 s, both signs
    dts = torch.cat([torch.arange(0, 200_000),
                     torch.logspace(5.3, 45, 20_000, base=2).long()])
    for sign in (1, -1):
        assert torch.equal(time_bucket((sign * dts).abs(), th),
                           reference.time_bucket(sign * dts, buckets))


@pytest.mark.parametrize("history,candidates", [(6, 0), (3, 3)])
def test_position_bias_at_the_sequence_ends(history, candidates):
    """With q = k = 0 and no time bias, A_ij = SiLU(p[j - i + N - 1]) / N:
    V the identity makes out[i, j] that weight, so each pair's position
    entry can be read off."""
    n = big_n = history + candidates
    layout = JaggedLayout((history,), (candidates,),
                          torch.tensor([0, history], dtype=torch.int32),
                          torch.tensor([0, candidates], dtype=torch.int32))
    p = torch.linspace(-1.0, 1.0, 2 * big_n - 1)
    zeros = torch.zeros((n, n))
    out = hstu_attention_ref(zeros, zeros, torch.eye(n), layout,
                             torch.zeros(n, dtype=torch.int64), p,
                             torch.zeros(2), torch.tensor([0, 2]), heads=1,
                             max_seq_len=big_n)
    mask = attention_mask(history, candidates, "cpu")
    i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    want = torch.nn.functional.silu(p[j - i + big_n - 1]) / big_n * mask
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    # the last token and the first: p[0]; the diagonal: p[N - 1]
    assert out[n - 1, 0] == torch.nn.functional.silu(p[0]) / big_n
    assert out[0, 0] == torch.nn.functional.silu(p[big_n - 1]) / big_n
    if candidates:        # a candidate sees no other candidate
        assert out[n - 1, history] == 0 and out[history, n - 1] == 0


def test_plain_attention_matches_the_reference_per_user():
    gen = torch.Generator().manual_seed(3)
    history, cands, heads, d, big_n = (8, 1, 30), (2, 4, 1), 2, 8, 40
    layout = JaggedLayout(history, cands,
                          torch.tensor([0, 8, 9, 39], dtype=torch.int32),
                          torch.tensor([0, 2, 6, 7], dtype=torch.int32))
    rows = layout.rows
    uvqk = torch.randn((rows, 4 * heads * d), generator=gen)
    u, v, q, k = torch.split(uvqk, heads * d, dim=1)
    times = torch.randint(0, 10 ** 7, (rows,), generator=gen)
    layer = {"pos_bias": torch.randn(2 * big_n - 1, generator=gen),
             "time_bias": torch.randn(129, generator=gen)}
    th = torch.tensor(bucket_thresholds(128))
    got = hstu_attention_ref(q, k, v, layout, times, layer["pos_bias"],
                             layer["time_bias"], th, heads=heads,
                             max_seq_len=big_n)
    cfg = {"d_qk": d, "max_seq_len": big_n, "time_buckets": 128}
    h0, c0 = 0, 0
    for n_h, m in zip(history, cands):
        idx = torch.cat([torch.arange(h0, h0 + n_h),
                         torch.arange(sum(history) + c0,
                                      sum(history) + c0 + m)])
        n = n_h + m
        want = reference.attention(
            q[idx].view(n, heads, d).transpose(0, 1),
            k[idx].view(n, heads, d).transpose(0, 1),
            v[idx].view(n, heads, d).transpose(0, 1), times[idx], layer,
            cfg, n_h)
        torch.testing.assert_close(got[idx], want, rtol=1e-6, atol=1e-7)
        h0, c0 = h0 + n_h, c0 + m
    assert layout.pairs() == sum(int(attention_mask(h, m, "cpu").sum())
                                 for h, m in zip(history, cands))


def test_configuration_is_registered_at_its_widths():
    assert "hstu-ranking" in ALL_ARCHS
    cfg = get_config("hstu-ranking")
    assert (cfg.d_model, cfg.heads, cfg.d_qk, cfg.d_v, cfg.layers) == (
        512, 4, 128, 128, 8)
    assert (cfg.max_seq_len, cfg.time_buckets, cfg.task_mlp) == (
        8448, 128, (512, 256, 1))
    assert (cfg.item_rows, cfg.action_rows, cfg.table_dtype, cfg.eps) == (
        50_000_000, 64, "bfloat16", 1e-6)
    model = HSTU(cfg, device="meta")
    assert model.ebc.tables.shape == (50_000_064, 512)
    assert model.ebc.tables.dtype == torch.bfloat16
    layer = model.encoder.layers[0]
    assert layer.w_uvqk.shape == (512, 2048)
    assert layer.pos_bias.shape == (2 * 8448 - 1,)
    assert layer.time_bias.shape == (129,)
    dense = sum(p.numel() for n, p in model.named_parameters())
    assert dense == 8 * (512 * 2048 + 512 * 512 + 512 + 16895 + 129) + (
        512 * 512 + 512 + 512 * 256 + 256 + 256 + 1)


def test_spans_nest_in_a_profiled_forward():
    model = make_model()
    batch = make_batch(events=(2, 5))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            model(batch)
    names = [e.name for e in prof.events()
             if e.name.startswith("repro_torch.")]
    for name in ("hstu.forward", "ebc.lookup", "hstu.head"):
        assert names.count("repro_torch." + name) == 1, name
    for name in ("hstu.uvqk", "hstu.attention", "hstu.output"):
        assert names.count("repro_torch." + name) == SMALL.layers, name


def test_the_kernel_refuses_cpu_tensors_and_other_devices():
    layout = JaggedLayout((2,), (1,), torch.tensor([0, 2], dtype=torch.int32),
                          torch.tensor([0, 1], dtype=torch.int32))
    x = torch.zeros((3, 128))
    args = (layout, torch.zeros(3, dtype=torch.int64), torch.zeros(7),
            torch.zeros(2), torch.tensor([0, 2]))
    with pytest.raises(ValueError, match="CPU tensors go to"):
        hstu_attention_cuda(x, x, x, *args, heads=1, max_seq_len=4)
    m = torch.zeros((3, 128), device="meta")
    with pytest.raises(ValueError, match="no HSTU attention"):
        hstu_attention(m, m, m, *args, heads=1, max_seq_len=4)
    with pytest.raises(ValueError, match="histories"):
        JaggedLayout((1, 2), (1,), layout.hist_offsets, layout.cand_offsets)
