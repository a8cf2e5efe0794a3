"""HSTU generative ranking in the port, on the CPU at a small size: the
jagged batch, the embedding stage on two tables with bags of one row, the
encoder's layers with the plain attention (`kernels/hstu_attention/ref.py`)
and the task MLP, against the plain reference `tests/_reference_hstu.py`
on seeded weights.

On the CPU the attention is the plain version; the CUDA kernel
(`csrc/hstu_attention.cu`) is held to it on the card by `chip_smoke.py`'s
`hstu` phase and by the benchmark's `hstu-ranking.long_hist` cell. The
kernel's time codes are held here through their plain version
(`ref.time_codes_ref`): its layout decoded by hand against the
double-precision bucket, and an attention that reads them against the
plain attention; the card's build is held to it byte for byte there."""
import bisect
import dataclasses
import itertools
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
                                                hstu_time_codes,
                                                time_bucket, time_codes_cuda,
                                                time_codes_ref)
from repro_torch.kernels.hstu_attention import kernel as hstu_kernel
from repro_torch.kernels.hstu_attention.ref import (MASKED, attention_mask,
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
    builds = (hstu_kernel.CODE_BUILDS, hstu_kernel.CODE_TILES)
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
    # the counters: token rows and masked-in pairs a head, this forward;
    # the layout's tiles of time codes, none of them built on the CPU
    assert model.tokens == 2 * sum(EVENTS) + 4 * CANDIDATES
    assert model.pairs == sum(2 * e * (2 * e + 1) // 2
                              + CANDIDATES * (2 * e + 1) for e in EVENTS)
    tiles = [math.ceil((2 * e + CANDIDATES) / 64) for e in EVENTS]
    assert batch.layout().code_tiles() == sum(t * (t + 1) // 2
                                              for t in tiles) == 6
    assert (hstu_kernel.CODE_BUILDS, hstu_kernel.CODE_TILES) == builds


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
    # the plain attention buckets the times itself: no codes are built
    assert "repro_torch.hstu.time_codes" not in names


def test_the_kernel_refuses_cpu_tensors_and_other_devices():
    layout = JaggedLayout((2,), (1,), torch.tensor([0, 2], dtype=torch.int32),
                          torch.tensor([0, 1], dtype=torch.int32))
    x = torch.zeros((3, 128))
    times, th = torch.zeros(3, dtype=torch.int64), torch.tensor([0, 2])
    codes = time_codes_ref(layout, times, th)
    before = (hstu_kernel.LAUNCHES, hstu_kernel.CODE_BUILDS,
              hstu_kernel.CODE_TILES)
    with pytest.raises(ValueError, match="CPU tensors go to"):
        hstu_attention_cuda(x, x, x, layout, codes, torch.zeros(7),
                            torch.zeros(2), heads=1, max_seq_len=4)
    m = torch.zeros((3, 128), device="meta")
    with pytest.raises(ValueError, match="no HSTU attention"):
        hstu_attention(m, m, m, layout, codes, torch.zeros(7),
                       torch.zeros(2), heads=1, max_seq_len=4)
    with pytest.raises(ValueError, match="histories"):
        JaggedLayout((1, 2), (1,), layout.hist_offsets, layout.cand_offsets)
    # the codes: on the CPU the times and thresholds as they are, which
    # the plain attention buckets; the build needs the card
    got = hstu_time_codes(layout, times, th)
    assert got[0] is times and got[1] is th
    with pytest.raises(ValueError, match="no HSTU time codes"):
        hstu_time_codes(layout, times.to("meta"), th.to("meta"))
    with pytest.raises(ValueError, match="needs times on a CUDA device"):
        time_codes_cuda(layout, times, th)
    assert (hstu_kernel.LAUNCHES, hstu_kernel.CODE_BUILDS,
            hstu_kernel.CODE_TILES) == before


# Layouts (history tokens, candidates a user) of the time-code tests:
# histories that are not a multiple of 64, 0 candidates, 0 history, one
# user, users of 1 token, and one user whose times put |dt| on every
# threshold and one either side ("thresholds", built per bucket count).
CODE_LAYOUTS = {
    "ragged": ((70, 1, 130), (5, 0, 3)),
    "no_candidates": ((100,), (0,)),
    "no_history": ((0,), (7,)),
    "single_user": ((64,), (64,)),
    "one_token_users": ((1, 0, 1, 2), (0, 1, 1, 0)),
    "thresholds": None,
}


def code_case(name: str, buckets: int, seed: int = 0):
    """(layout, times, thresholds) of a CODE_LAYOUTS entry. Times are
    uniform over 1e7 s, except in "thresholds": one user whose history
    rises 0, th[b] - 1, th[b], th[b] + 1 (b = 1..B), then falls back, so
    that every pair with token 0 and its mirror give those |dt| both
    ways, and 2 candidates at th[B] + 5."""
    th = bucket_thresholds(buckets)
    gen = torch.Generator().manual_seed(seed)
    if name == "thresholds":
        rise = [0] + [th[b] + d for b in range(1, buckets + 1)
                      for d in (-1, 0, 1)]
        hist = rise + rise[::-1]
        history, candidates = (len(hist),), (2,)
        times = torch.tensor(hist + [th[buckets] + 5] * 2)
    else:
        history, candidates = CODE_LAYOUTS[name]
        times = torch.randint(0, 10 ** 7, (sum(history) + sum(candidates),),
                              generator=gen)
    layout = JaggedLayout(
        history, candidates,
        torch.tensor([0, *itertools.accumulate(history)], dtype=torch.int32),
        torch.tensor([0, *itertools.accumulate(candidates)],
                     dtype=torch.int32))
    return layout, times, torch.tensor(th)


def decode(codes: torch.Tensor, layout: JaggedLayout) -> list:
    """Each user's [64 T, 64 T] codes read back from the buffer by the
    layout's rule (pairs above the tile diagonal, which are not stored,
    read -1); and the count of bytes read, each once."""
    out, base, seen = [], 0, torch.zeros(codes.numel(), dtype=torch.int64)
    for n_h, m in zip(layout.history, layout.candidates):
        t = math.ceil((n_h + m) / 64)
        i, j = torch.meshgrid(torch.arange(64 * t), torch.arange(64 * t),
                              indexing="ij")
        a, b = i // 64, j // 64
        stored = b <= a
        at = ((base + a * (a + 1) // 2 + b) * 4096
              + 16 * (16 * (i % 16) + j % 16) + 4 * (i % 64 // 16)
              + j % 64 // 16)
        user = torch.full((64 * t, 64 * t), -1, dtype=torch.int64)
        user[stored] = codes[at[stored]].long()
        seen.index_add_(0, at[stored], torch.ones_like(at[stored]))
        out.append(user)
        base += t * (t + 1) // 2
    assert bool((seen == 1).all()), "a byte read twice or never"
    return out


def user_slices(layout: JaggedLayout) -> list:
    return [torch.cat([torch.arange(h0, h0 + n_h),
                       torch.arange(layout.hist_total + c0,
                                    layout.hist_total + c0 + m)])
            for n_h, m, h0, c0 in zip(
                layout.history, layout.candidates,
                itertools.accumulate(layout.history, initial=0),
                itertools.accumulate(layout.candidates, initial=0))]


@pytest.mark.parametrize("buckets", [128, 3])
@pytest.mark.parametrize("name", list(CODE_LAYOUTS))
def test_time_codes_are_each_pairs_bucket_or_the_mask(name, buckets):
    layout, times, th = code_case(name, buckets)
    codes = time_codes_ref(layout, times, th)
    assert codes.dtype == torch.uint8
    assert codes.numel() == layout.code_tiles() * 4096
    edges = th.tolist()

    def bucket(x):
        # beyond 2**53 a double no longer tells integers apart: there the
        # thresholds alone define the bucket
        return (time_bucket_of(x, buckets) if x < 2 ** 53
                else bisect.bisect_right(edges, x) - 1)

    for rows, user, n_h, m in zip(user_slices(layout), decode(codes, layout),
                                  layout.history, layout.candidates):
        n = n_h + m
        t = times[rows].tolist()
        for i in range(user.shape[0]):
            for j in range(i // 64 * 64 + 64):
                in_mask = i < n and j < n and (j <= i if i < n_h
                                               else j < n_h or j == i)
                want = bucket(abs(t[i] - t[j])) if in_mask else MASKED
                assert user[i, j] == want, (i, j)
    if name == "thresholds":       # every bucket no integer skips is met
        met = {b for b in range(buckets + 1)
               if b == buckets or edges[b] < edges[b + 1]}
        assert set(codes.tolist()) == met | {MASKED}


def attention_from_codes(q, k, v, layout, codes, pos_bias, time_bias, *,
                         heads, max_seq_len):
    """The attention as the kernel computes it from the codes: code MASKED
    gives weight 0, any other c the bias p[j - i + N - 1] + w[c]."""
    out = torch.zeros((q.shape[0], v.shape[1]))
    d = q.shape[1] // heads
    for rows, user in zip(user_slices(layout), decode(codes, layout)):
        n = rows.numel()
        code = user[:n, :n]
        qu, ku, vu = (x[rows].view(n, heads, -1).transpose(0, 1)
                      for x in (q, k, v))
        pos = torch.arange(n)
        rab = (pos_bias[pos[None, :] - pos[:, None] + max_seq_len - 1]
               + time_bias[code.clamp(max=time_bias.numel() - 1)])
        a = torch.nn.functional.silu(d ** -0.5 * (qu @ ku.transpose(1, 2))
                                     + rab) / max_seq_len
        a = a * ((code >= 0) & (code != MASKED))   # -1: above the tiles
        out[rows] = (a @ vu).transpose(0, 1).reshape(n, -1)
    return out


@pytest.mark.parametrize("buckets", [128, 3])
@pytest.mark.parametrize("name", list(CODE_LAYOUTS))
def test_attention_read_from_codes_matches_the_plain_attention(name,
                                                               buckets):
    layout, times, th = code_case(name, buckets, seed=1)
    gen = torch.Generator().manual_seed(2)
    heads, d, big_n = 2, 8, max(layout.longest(), 1)
    q, k, v = torch.randn((3, layout.rows, heads * d), generator=gen)
    pos = torch.randn(2 * big_n - 1, generator=gen)
    tw = torch.randn(buckets + 1, generator=gen)
    want = hstu_attention_ref(q, k, v, layout, times, pos, tw, th,
                              heads=heads, max_seq_len=big_n)
    got = attention_from_codes(q, k, v, layout,
                               time_codes_ref(layout, times, th), pos, tw,
                               heads=heads, max_seq_len=big_n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(CODE_LAYOUTS))
def test_code_tiles_are_the_users_triangles(name):
    layout, _, _ = code_case(name, 3)
    tiles = [math.ceil((h + c) / 64)
             for h, c in zip(layout.history, layout.candidates)]
    assert layout.code_tiles() == sum(t * (t + 1) // 2 for t in tiles)
    assert layout.code_tiles() == {
        "ragged": 3 + 1 + 6, "no_candidates": 3, "no_history": 1,
        "single_user": 3, "one_token_users": 4, "thresholds": 1}[name]


def _bad_codes(case, layout, device="cpu"):
    """A code buffer that is not the layout's, made on `device` (a copy to
    another device would make a strided or unaligned view whole again)."""
    n = layout.code_tiles() * 4096
    good = torch.zeros(n, dtype=torch.uint8, device=device)
    return {"short": good[:-1],
            "long": torch.zeros(n + 16, dtype=torch.uint8, device=device),
            "int8": good.to(torch.int8), "int32": good.to(torch.int32),
            "strided": torch.zeros(2 * n, dtype=torch.uint8,
                                   device=device)[::2],
            "unaligned": torch.zeros(n + 1, dtype=torch.uint8,
                                     device=device)[1:],
            "device": good.to("meta"), "none": None}[case]


@pytest.mark.parametrize("case", ["short", "long", "int8", "int32",
                                  "strided", "unaligned", "device", "none"])
def test_a_code_buffer_not_the_layouts_is_refused(case):
    layout, times, th = code_case("ragged", 128)
    hstu_kernel.check_codes(time_codes_ref(layout, times, th), layout, "cpu")
    with pytest.raises(ValueError, match="codes must be the layout's"):
        hstu_kernel.check_codes(_bad_codes(case, layout), layout, "cpu")


@pytest.mark.parametrize("buckets", [255, 1000])
def test_more_than_254_buckets_are_refused(buckets):
    assert hstu_kernel.MAX_BUCKETS == 254
    layout, times, _ = code_case("ragged", 3)
    # rising thresholds of any count (the reference base passes 2**63 at
    # 145 buckets)
    th = torch.arange(buckets + 1) * 1000
    with pytest.raises(ValueError, match="at most 254"):
        time_codes_ref(layout, times, th)
    with pytest.raises(ValueError, match="at most 254"):
        time_codes_cuda(layout, times, th)
    codes = time_codes_ref(layout, times, th[:255])   # 254: accepted
    assert int(codes[codes != MASKED].max()) <= 254


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the kernels on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["short", "int8", "strided", "unaligned",
                                  "cpu", "buckets"])
def test_the_kernel_refuses_codes_not_the_layouts_on_the_card(case,
                                                              cuda_device):
    layout, times, th = code_case("ragged", 128)
    layout = JaggedLayout(layout.history, layout.candidates,
                          layout.hist_offsets.to(cuda_device),
                          layout.cand_offsets.to(cuda_device))
    x = torch.zeros((layout.rows, 128), device=cuda_device)
    codes = time_codes_cuda(layout, times.to(cuda_device),
                            th.to(cuda_device))
    tw = torch.zeros(129, device=cuda_device)
    if case == "cpu":
        codes = codes.cpu()
    elif case == "buckets":
        tw = torch.zeros(256, device=cuda_device)
    else:
        codes = _bad_codes(case, layout, cuda_device)
    before = hstu_kernel.LAUNCHES
    with pytest.raises(ValueError, match="codes must be|at most 254"):
        hstu_attention_cuda(x, x, x, layout, codes,
                            torch.zeros(2 * 200 - 1, device=cuda_device), tw,
                            heads=1, max_seq_len=200)
    assert hstu_kernel.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("buckets", [128, 3])
@pytest.mark.parametrize("name", list(CODE_LAYOUTS))
def test_the_build_writes_time_codes_ref_on_the_card(name, buckets,
                                                     cuda_device):
    layout, times, th = code_case(name, buckets)
    want = time_codes_ref(layout, times, th)
    layout = JaggedLayout(layout.history, layout.candidates,
                          layout.hist_offsets.to(cuda_device),
                          layout.cand_offsets.to(cuda_device))
    before = (hstu_kernel.CODE_BUILDS, hstu_kernel.CODE_TILES)
    got = hstu_time_codes(layout, times.to(cuda_device), th.to(cuda_device))
    assert torch.equal(got.cpu(), want)
    assert (hstu_kernel.CODE_BUILDS, hstu_kernel.CODE_TILES) == (
        before[0] + 1, before[1] + layout.code_tiles())
