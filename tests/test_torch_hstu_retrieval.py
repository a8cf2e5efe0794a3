"""HSTU generative retrieval in the port, on the CPU at a small size: the
history-only jagged batch through the encoder, each user's query, and the
exact top-K scan of the item rows (`kernels/mips_topk`, its plain version
on the CPU), against the plain reference `tests/_reference_hstu_retrieval.py`
on seeded weights; and the history-only layout through the attention's
plain version and its time codes.

The plain scan reproduces the kernel's scores bit for bit (fmaf over the
dims in order, emulated in float64); the CUDA kernel (`csrc/mips_topk.cu`)
is held to it on the card by the tests marked `cuda` here, by
`chip_smoke.py`'s `hstu_retrieval` phase and by the benchmark's
`hstu-retrieval.hist_1k` cell."""
import dataclasses
import itertools

import pytest
import torch

import _reference_hstu as hstu_reference
import _reference_hstu_retrieval as reference
from test_torch_hstu import (SMALL, attention_from_codes, decode, gap,
                             make_batch, ref_cfg, user_slices)
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels.hstu_attention import (JaggedLayout,
                                                bucket_thresholds,
                                                hstu_attention_ref,
                                                hstu_time_codes,
                                                time_codes_ref)
from repro_torch.kernels.hstu_attention import kernel as hstu_kernel
from repro_torch.kernels.hstu_attention.ref import MASKED, time_bucket_of
from repro_torch.kernels.mips_topk import (mips_topk, mips_topk_cuda,
                                           mips_topk_ref, scores_ref)
from repro_torch.kernels.mips_topk import kernel as mips_kernel
from repro_torch.models.hstu import HSTU, HSTUConfig

# SMALL's widths; a corpus of a few thousand bf16 item rows, K = 16
RETRIEVAL = dataclasses.replace(SMALL, task_mlp=(), retrieve_k=16,
                                item_rows=3000, action_rows=8,
                                table_dtype="bfloat16")
EVENTS = (1, 3, 17, 40)
K = 16
# Both sides score in f32: the plain scan a dim at a time, the reference
# by a product over every dim, so a score may differ in its last places
# (32 terms); the encoder's states differ as in test_torch_hstu.py.
SCORE_RTOL = 1e-6
STATE_TOL = 1e-5


def make_model(cfg: HSTUConfig = RETRIEVAL, seed: int = 0) -> HSTU:
    """The model on seeded weights, b_o drawn N(0, 0.05) so that the
    comparison sees it."""
    model = HSTU(cfg, device="cpu", seed=seed).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("b_o"):
                p.normal_(0.0, 0.05, generator=gen)
    return model


def history_batch(events=EVENTS, cfg=RETRIEVAL, seed=0):
    return make_batch(events, 0, cfg, seed)


def reference_of(model: HSTU, batch, k=K):
    layers = [{name: getattr(layer, name) for name in
               ("w_uvqk", "w_o", "b_o", "pos_bias", "time_bias")}
              for layer in model.encoder.layers]
    with torch.no_grad():
        return reference.retrieve(model.ebc.tables, layers,
                                  ref_cfg(model.cfg), batch.events,
                                  batch.item_ids, batch.action_ids,
                                  batch.timestamps, k)


def assert_retrieved(got_ids, got_scores, want_ids, want_scores):
    assert got_ids.dtype == torch.int32 and got_scores.dtype == torch.float32
    assert torch.equal(got_ids.long(), want_ids)
    torch.testing.assert_close(got_scores, want_scores, rtol=SCORE_RTOL,
                               atol=0)


def test_jagged_histories_match_the_reference():
    model = make_model()
    batch = history_batch()
    held = {}
    hook = model.encoder.register_forward_hook(
        lambda mod, args, out: held.__setitem__("states", out))
    with torch.inference_mode():
        ids, scores, queries = model.retrieve(batch)
    hook.remove()
    want_states, want_ids, want_scores, want_q = reference_of(model, batch)
    assert ids.shape == scores.shape == (len(EVENTS), K)
    assert queries.shape == (len(EVENTS), 32)
    assert gap(held["states"], want_states) <= STATE_TOL
    assert gap(queries, want_q) <= STATE_TOL
    torch.testing.assert_close(queries.norm(dim=1),
                               torch.ones(len(EVENTS)), rtol=1e-6, atol=0)
    assert_retrieved(ids, scores, want_ids, want_scores)
    # best first
    assert bool((scores[:, 1:] <= scores[:, :-1]).all())
    # the scores are the plain scan's of the returned queries, bit for bit
    items = model.ebc.tables[:RETRIEVAL.item_rows]
    assert torch.equal(scores, scores_ref(queries, items).gather(
        1, ids.long()))


def test_a_users_retrieval_does_not_depend_on_the_batch():
    model = make_model()
    batch = history_batch()
    with torch.inference_mode():
        ids, scores, _ = model.retrieve(batch)
        for u, e in enumerate(EVENTS):
            lo = sum(EVENTS[:u])
            alone = history_batch((e,))
            alone = dataclasses.replace(
                alone, item_ids=batch.item_ids[lo:lo + e],
                action_ids=batch.action_ids[lo:lo + e],
                timestamps=batch.timestamps[lo:lo + e])
            got_ids, got_scores, _ = model.retrieve(alone)
            assert torch.equal(got_ids[0], ids[u])
            torch.testing.assert_close(got_scores[0], scores[u],
                                       rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize("block_rows", [1, 7, 511, 512, 513, 2999, 3000])
def test_blocks_of_rows_straddled_give_the_same_k(block_rows):
    gen = torch.Generator().manual_seed(4)
    queries = torch.nn.functional.normalize(
        torch.randn((5, 32), generator=gen), dim=1)
    rows = (torch.randn((3000, 32), generator=gen) / 32 ** 0.5).to(
        torch.bfloat16)
    ids, scores = mips_topk_ref(queries, rows, K, block_rows=block_rows)
    whole_ids, whole_scores = mips_topk_ref(queries, rows, K,
                                            block_rows=3000)
    assert torch.equal(ids, whole_ids) and torch.equal(scores, whole_scores)
    want_ids, want_scores = reference.top_k(queries, rows, K,
                                            block_rows=block_rows)
    assert_retrieved(ids, scores, want_ids, want_scores)


def test_duplicate_rows_tie_to_the_smaller_id():
    model = make_model()
    batch = history_batch()
    with torch.inference_mode():
        _, _, queries = model.retrieve(batch)
        best = model.ebc.tables[:RETRIEVAL.item_rows].float() @ queries.T
        top = int(best[:, 0].argmax())
        # rows 5, 900 and 2999 become copies of user 0's best row, which
        # then ties four ways
        tables = model.ebc.tables
        for r in (5, 900, 2999):
            tables[r] = tables[top]
        ids, scores, _ = model.retrieve(batch)
    copies = sorted({5, 900, 2999, top})
    assert ids[0, :4].tolist() == copies
    assert len(set(scores[0, :4].tolist())) == 1
    _, want_ids, want_scores, _ = reference_of(model, batch)
    assert_retrieved(ids, scores, want_ids, want_scores)
    # and in the plain scan alone: a corpus of one row repeated
    rows = torch.ones((40, 32), dtype=torch.bfloat16)
    got, s = mips_topk(queries, rows, 10)
    assert got.tolist() == [list(range(10))] * len(EVENTS)
    assert bool((s == s[:, :1]).all())


def test_k_over_the_corpus_and_too_many_users_are_refused():
    model = make_model()
    rows = model.ebc.tables[:RETRIEVAL.item_rows]
    q = torch.zeros((33, 32))
    for queries, k, match in ((q[:4], RETRIEVAL.item_rows + 1, "k=3001"),
                              (q[:4], 0, "k=0"),
                              (q, 8, "33 queries"),
                              (q[:0], 8, "0 queries"),
                              (q[:4].double(), 8, "float32")):
        with pytest.raises(ValueError, match=match):
            mips_topk(queries, rows, k)
    too_many = make_model(dataclasses.replace(
        RETRIEVAL, retrieve_k=RETRIEVAL.item_rows + 1))
    with pytest.raises(ValueError, match="k=3001"):
        too_many.retrieve(history_batch())
    many = history_batch((1,) * 33)
    with pytest.raises(ValueError, match="33 queries"):
        model.retrieve(many)
    # histories alone, each with an engagement
    with pytest.raises(ValueError, match="candidate count"):
        model.retrieve(make_batch(EVENTS, 2, RETRIEVAL))
    with pytest.raises(ValueError, match="needs an engagement"):
        model.retrieve(history_batch((3, 0)))
    # the card's entry refuses CPU tensors; a ranking entry is refused
    with pytest.raises(ValueError, match="CPU tensors go to"):
        mips_topk_cuda(q[:4], rows, 8)
    with pytest.raises(ValueError, match="no task MLP"):
        model(history_batch())


def test_counters_and_the_spans_nest():
    model = make_model()
    batch = history_batch(events=(2, 5, 9))
    before = (mips_kernel.LAUNCHES, mips_kernel.ROWS_SCANNED,
              hstu_kernel.CODE_BUILDS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            model.retrieve(batch)
    layout = batch.layout()
    assert (model.tokens, model.pairs, model.queries) == (
        32, layout.pairs(), 3)
    assert layout.pairs() == sum(n * (n + 1) // 2 for n in (4, 10, 18))
    # the plain scan and the plain attention: no kernel launched
    assert (mips_kernel.LAUNCHES, mips_kernel.ROWS_SCANNED,
            hstu_kernel.CODE_BUILDS) == before
    ranges = {}
    for e in prof.events():
        if e.name.startswith("repro_torch."):
            ranges.setdefault(e.name[len("repro_torch."):], []).append(
                (e.time_range.start, e.time_range.end))
    for name in ("hstu.retrieve", "ebc.lookup", "hstu.query", "hstu.mips"):
        assert len(ranges.get(name, [])) == 1, name
    for name in ("hstu.uvqk", "hstu.attention", "hstu.output"):
        assert len(ranges[name]) == RETRIEVAL.layers, name
    assert "hstu.forward" not in ranges and "hstu.head" not in ranges
    (r0, r1), = ranges["hstu.retrieve"]
    inside = [s for name, spans in ranges.items()
              if name != "hstu.retrieve" for s in spans]
    assert all(r0 <= s <= e <= r1 for s, e in inside)
    # the query, then the scan, after the last layer
    (q0, q1), (m0, m1) = ranges["hstu.query"][0], ranges["hstu.mips"][0]
    assert max(e for _, e in ranges["hstu.output"]) <= q0 <= q1 <= m0 <= m1


def test_configuration_is_registered_at_its_widths():
    assert "hstu-retrieval" in ALL_ARCHS
    cfg = get_config("hstu-retrieval")
    ranking = get_config("hstu-ranking")
    for f in ("d_model", "heads", "d_qk", "d_v", "layers", "time_buckets",
              "item_rows", "action_rows", "table_dtype", "eps"):
        assert getattr(cfg, f) == getattr(ranking, f), f
    assert (cfg.max_seq_len, cfg.task_mlp, cfg.retrieve_k) == (8192, (), 256)
    assert (ranking.max_seq_len, ranking.retrieve_k) == (8448, 0)
    model = HSTU(cfg, device="meta")
    assert model.head is None
    assert model.ebc.tables.shape == (50_000_064, 512)
    assert model.ebc.tables.dtype == torch.bfloat16
    assert model.encoder.layers[0].pos_bias.shape == (2 * 8192 - 1,)
    dense = sum(p.numel() for p in model.parameters())
    assert dense == 8 * (512 * 2048 + 512 * 512 + 512 + 16383 + 129)
    # the ranking model's state dict keeps its names
    names = set(HSTU(ranking, device="meta").state_dict())
    assert {n for n in names if not n.startswith("head.")} == set(
        model.state_dict())
    assert {"head.w0", "head.b0", "head.w1", "head.b1"} <= names
    for bad in (dict(task_mlp=(), retrieve_k=0),
                dict(task_mlp=(8, 1), retrieve_k=16)):
        with pytest.raises(ValueError, match="one of them"):
            dataclasses.replace(RETRIEVAL, **bad)


# History-only layouts: several users, every candidate count 0, lengths
# that are and are not multiples of 64 (the retrieval cell's batches).
HISTORY_ONLY = ((128, 2, 70, 190, 1, 64), (0,) * 6)


def history_only_case(seed=0):
    history, candidates = HISTORY_ONLY
    gen = torch.Generator().manual_seed(seed)
    layout = JaggedLayout(
        history, candidates,
        torch.tensor([0, *itertools.accumulate(history)], dtype=torch.int32),
        torch.zeros(len(history) + 1, dtype=torch.int32))
    times = torch.randint(0, 10 ** 7, (layout.rows,), generator=gen)
    return layout, times, torch.tensor(bucket_thresholds(128))


def test_history_only_layout_through_the_plain_attention():
    layout, times, th = history_only_case()
    assert layout.hist_total == layout.rows == sum(HISTORY_ONLY[0])
    gen = torch.Generator().manual_seed(2)
    heads, d, big_n = 2, 8, 200
    q, k, v = torch.randn((3, layout.rows, heads * d), generator=gen)
    layer = {"pos_bias": torch.randn(2 * big_n - 1, generator=gen),
             "time_bias": torch.randn(129, generator=gen)}
    got = hstu_attention_ref(q, k, v, layout, times, layer["pos_bias"],
                             layer["time_bias"], th, heads=heads,
                             max_seq_len=big_n)
    cfg = {"d_qk": d, "max_seq_len": big_n, "time_buckets": 128}
    for rows, n in zip(user_slices(layout), HISTORY_ONLY[0]):
        want = hstu_reference.attention(
            *(x[rows].view(n, heads, d).transpose(0, 1) for x in (q, k, v)),
            times[rows], layer, cfg, n)
        torch.testing.assert_close(got[rows], want, rtol=1e-6, atol=1e-7)
    # its time codes: each pair's bucket in the causal triangle, the mask
    # elsewhere, and an attention read from them equal to the plain one
    codes = time_codes_ref(layout, times, th)
    assert codes.numel() == layout.code_tiles() * 4096
    assert layout.code_tiles() == 3 + 1 + 3 + 6 + 1 + 1
    for rows, user, n in zip(user_slices(layout), decode(codes, layout),
                             HISTORY_ONLY[0]):
        t = times[rows].tolist()
        for i in range(user.shape[0]):
            for j in range(i // 64 * 64 + 64):
                want = (time_bucket_of(abs(t[i] - t[j]), 128)
                        if i < n and j <= i else MASKED)
                assert user[i, j] == want, (i, j)
    from_codes = attention_from_codes(q, k, v, layout, codes,
                                      layer["pos_bias"], layer["time_bias"],
                                      heads=heads, max_seq_len=big_n)
    torch.testing.assert_close(from_codes, got, rtol=1e-6, atol=1e-7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the kernels on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_history_only_layout_on_the_card(cuda_device):
    """The build writes the history-only layout's codes byte for byte, and
    the attention kernel reads them as the plain version computes."""
    layout, times, th = history_only_case(seed=1)
    want_codes = time_codes_ref(layout, times, th)
    card = JaggedLayout(layout.history, layout.candidates,
                        layout.hist_offsets.to(cuda_device),
                        layout.cand_offsets.to(cuda_device))
    codes = hstu_time_codes(card, times.to(cuda_device), th.to(cuda_device))
    assert torch.equal(codes.cpu(), want_codes)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    uvqk = torch.nn.functional.silu(torch.randn(
        (layout.rows, 4 * 512), generator=gen, device=cuda_device) * 0.5)
    _, v, q, k = torch.split(uvqk, 512, dim=1)
    pos = torch.randn(2 * 8192 - 1, generator=gen, device=cuda_device)
    tw = torch.randn(129, generator=gen, device=cuda_device)
    before = hstu_kernel.LAUNCHES
    got = hstu_kernel.hstu_attention(q, k, v, card, codes, pos, tw, heads=4,
                                     max_seq_len=8192)
    assert hstu_kernel.LAUNCHES == before + 1
    want = hstu_attention_ref(q, k, v, card, times.to(cuda_device), pos, tw,
                              th.to(cuda_device), heads=4, max_seq_len=8192)
    assert gap(got, want) <= 1e-5


# (users, rows, d, k): the scan's tiles (1,024 rows for 16 queries held,
# 512 for 32) and their edges, one row short of a tile and one past, k = 1,
# k = rows and the largest k, d of one stage and of many
CARD_CASES = [(1, 1, 16, 1), (3, 1023, 48, 16), (16, 1024, 64, 256),
              (16, 1025, 512, 256), (17, 511, 96, 100), (32, 513, 512, 1),
              (32, 4097, 512, 64), (5, 300, 32, 300),
              (16, 20000, 512, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("users,rows,dim,k", CARD_CASES)
def test_the_kernel_is_the_plain_scan_on_the_card(users, rows, dim, k,
                                                  cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + users)
    queries = torch.nn.functional.normalize(torch.randn(
        (users, dim), generator=gen, device=cuda_device), dim=1)
    corpus = (torch.randn((rows, dim), generator=gen, device=cuda_device)
              / dim ** 0.5).to(torch.bfloat16)
    # a few exact copies: ties
    corpus[rows // 2:rows // 2 + 3] = corpus[0]
    before = (mips_kernel.LAUNCHES, mips_kernel.ROWS_SCANNED)
    ids, scores = mips_topk(queries, corpus, k)
    assert (mips_kernel.LAUNCHES, mips_kernel.ROWS_SCANNED) == (
        before[0] + 2, before[1] + rows)
    want_ids, want_scores = mips_topk_ref(queries, corpus, k)
    assert torch.equal(ids, want_ids)
    assert torch.equal(scores, want_scores)


@pytest.mark.cuda
def test_the_kernel_refuses_what_it_cannot_scan(cuda_device):
    q = torch.zeros((4, 64), device=cuda_device)
    rows = torch.zeros((600, 64), dtype=torch.bfloat16, device=cuda_device)
    before = mips_kernel.LAUNCHES
    for queries, corpus, match in (
            (q, rows.float(), "bfloat16"),
            (q[:, :40].contiguous(), rows[:, :40].contiguous(),
             "multiple of 16"),
            (torch.zeros((17, 1024), device=cuda_device),
             torch.zeros((600, 1024), dtype=torch.bfloat16,
                         device=cuda_device), "<= 65536"),
            (q, rows[:, :64].t().contiguous().t(), "contiguous rows"),
            (q.cpu(), rows, "queries on cpu")):
        with pytest.raises(ValueError, match=match):
            mips_topk_cuda(queries, corpus, 8)
    assert mips_kernel.LAUNCHES == before


@pytest.mark.cuda
def test_retrieval_on_the_card_is_the_cpu_path(cuda_device):
    cfg = dataclasses.replace(RETRIEVAL, d_model=512, heads=4, d_qk=128,
                              d_v=128, max_seq_len=8192, item_rows=70_000,
                              retrieve_k=256)
    model = make_model(cfg)
    batch = history_batch((1, 30, 200, 64), cfg)
    with torch.inference_mode():
        want_ids, want_scores, want_q = model.retrieve(batch)
        model = model.to(cuda_device)
        card = type(batch)(**{
            f.name: (getattr(batch, f.name).to(cuda_device)
                     if isinstance(getattr(batch, f.name), torch.Tensor)
                     else getattr(batch, f.name))
            for f in dataclasses.fields(batch)})
        before = (mips_kernel.LAUNCHES, mips_kernel.ROWS_SCANNED)
        ids, scores, queries = model.retrieve(card)
    assert (mips_kernel.LAUNCHES, mips_kernel.ROWS_SCANNED) == (
        before[0] + 2, before[1] + cfg.item_rows)
    assert gap(queries.cpu(), want_q) <= 1e-5
    # the card's scan of the card's queries is the plain scan's
    items = model.ebc.tables[:cfg.item_rows]
    plain_ids, plain_scores = mips_topk_ref(queries, items, 256)
    assert torch.equal(ids, plain_ids) and torch.equal(scores, plain_scores)
    assert (ids.cpu() == want_ids).float().mean() > 0.99
