"""The port's fused warm-cache lookup against the TPU path's, on the CPU.

The same numpy inputs go through the JAX package's
`fused_warm_lookup(backend="xla")` / `complete_miss_bags` and the port's
`fused_warm_lookup(backend="plain")` / `complete_miss_bags` (CPU tensors,
so the plain version). Miss lists are exactly equal; pooled values within
the summation bound 2·eps·Σ|w·x| over the rows each bag adds (zero at
MISS/PAD), carried through the mean's division (`ref.summation_bound`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import complete_miss_bags as j_complete
from repro.kernels.embedding_bag import fused_warm_lookup as j_fused
from repro_torch.kernels.embedding_bag import fused, kernel, ref

C, K, D, R = 40, 12, 16, 300


def _inputs(mix, batch=13, pooling=9, num_hot=K, cache_rows=C, seed=0,
            weighted=False):
    rng = np.random.default_rng(seed)
    cache = rng.normal(size=(cache_rows, D)).astype(np.float32)
    hot = rng.normal(size=(num_hot, D)).astype(np.float32)
    rows = rng.integers(0, R, size=(batch, pooling)).astype(np.int32)
    hits = rng.integers(0, num_hot + cache_rows, size=rows.shape)
    draw = rng.random(rows.shape)
    if mix == "hit":
        slots = hits
    elif mix == "miss":
        slots = np.full(rows.shape, fused.MISS)
    else:
        slots = np.where(draw < 0.4, fused.MISS, hits)
        if mix == "pad":
            slots = np.where(draw > 0.9, fused.PAD, slots)
            slots[-2:] = fused.PAD
    w = rng.random(rows.shape).astype(np.float32) if weighted else None
    return cache, hot if num_hot else None, slots.astype(np.int32), rows, w


def _bound(cache, hot, slots, w, mode):
    """ref.summation_bound over the rows each bag adds."""
    parts = ([] if hot is None else [hot]) + [cache, np.zeros((1, D),
                                                              np.float32)]
    eff = torch.from_numpy(np.concatenate(parts))
    zero_row = eff.shape[0] - 1
    s = torch.from_numpy(slots).long()
    idx = torch.where((s >= 0) & (s < zero_row), s,
                      torch.full_like(s, zero_row))
    return ref.summation_bound(eff, idx, None if w is None
                               else torch.from_numpy(w), mode)


def _jax(cache, hot, slots, rows, w, mode):
    return j_fused(jnp.asarray(cache), slots, rows,
                   None if w is None else jnp.asarray(w),
                   None if hot is None else jnp.asarray(hot), mode=mode,
                   backend="xla")


def _port(cache, hot, slots, rows, w, mode):
    return fused.fused_warm_lookup(
        torch.from_numpy(cache), slots, rows,
        None if w is None else torch.from_numpy(w),
        None if hot is None else torch.from_numpy(hot), mode=mode,
        backend="plain")


def _assert_within(got, want, bound):
    err = (torch.as_tensor(np.asarray(got)) - torch.as_tensor(
        np.asarray(want))).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("mix", ["hit", "mixed", "miss", "pad"])
@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True),
                                           ("mean", False), ("mean", True)])
@pytest.mark.parametrize("num_hot", [0, K])
def test_plain_matches_jax_xla(mix, mode, weighted, num_hot):
    cache, hot, slots, rows, w = _inputs(mix, num_hot=num_hot,
                                         weighted=weighted, seed=num_hot)
    want = _jax(cache, hot, slots, rows, w, mode)
    got = _port(cache, hot, slots, rows, w, mode)
    np.testing.assert_array_equal(got.miss_rows, want.miss_rows)
    np.testing.assert_array_equal(got.miss_pos, want.miss_pos)
    assert got.miss_rows.dtype == got.miss_pos.dtype == np.int32
    assert got.fully_resident == want.fully_resident == (mix == "hit")
    _assert_within(got.pooled, want.pooled, _bound(cache, hot, slots, w,
                                                   mode))


@pytest.mark.parametrize("case", ["empty_bags", "zero_capacity"])
def test_degenerate_shapes_match_jax(case):
    if case == "empty_bags":
        cache, hot, slots, rows, w = _inputs("mixed", pooling=0)
    else:
        cache, hot, slots, rows, w = _inputs("mixed", cache_rows=0)
    for mode in ("sum", "mean"):
        want = _jax(cache, hot, slots, rows, w, mode)
        got = _port(cache, hot, slots, rows, w, mode)
        np.testing.assert_array_equal(got.miss_rows, want.miss_rows)
        np.testing.assert_array_equal(got.miss_pos, want.miss_pos)
        np.testing.assert_allclose(got.pooled.numpy(),
                                   np.asarray(want.pooled), rtol=1e-6,
                                   atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True),
                                           ("mean", False)])
def test_complete_miss_bags_matches_jax_and_restores_the_dense_bag(
        mode, weighted):
    """Completion recomputes each miss bag whole: against the JAX helper
    within the bound, and bit for bit the port's dense pooling of those
    bags."""
    cache, hot, slots, rows, w = _inputs("mixed", weighted=weighted)
    table = np.random.default_rng(9).normal(size=(R, D)).astype(np.float32)
    res = _port(cache, hot, slots, rows, w, "sum")
    bags = np.unique(res.miss_pos // slots.shape[1])
    bag_rows = table[rows[bags]]
    jres = _jax(cache, hot, slots, rows, w, "sum")
    want = j_complete(jres.pooled, bags, bag_rows,
                      None if w is None else jnp.asarray(w), mode=mode)
    got = fused.complete_miss_bags(
        res.pooled, bags, bag_rows,
        None if w is None else torch.from_numpy(w), mode=mode)
    got_b = got[torch.from_numpy(bags)]
    want_b = np.asarray(want)[bags]
    dense = ref.summation_bound(torch.from_numpy(table),
                                torch.from_numpy(rows[bags]),
                                None if w is None
                                else torch.from_numpy(w[bags]), mode)
    _assert_within(got_b, want_b, dense)
    # bit for bit the port's dense path on the same bags
    from repro_torch.core.embedding import _pool_rows_core
    tw = None if w is None else torch.from_numpy(w[bags])[:, None]
    np.testing.assert_array_equal(
        got_b.numpy(),
        _pool_rows_core(torch.from_numpy(bag_rows)[:, None], tw,
                        mode)[:, 0].numpy())
    untouched = np.setdiff1d(np.arange(slots.shape[0]), bags)
    np.testing.assert_array_equal(got[torch.from_numpy(untouched)].numpy(),
                                  res.pooled[torch.from_numpy(untouched)]
                                  .numpy())
    assert fused.complete_miss_bags(res.pooled, [], bag_rows) is res.pooled


def test_bad_input_is_nan_and_left_out_of_the_lists():
    """A slot past K + C, or a MISS whose row lies outside [0, R), makes
    its bag NaN and never reaches the miss list — the kernel's rule."""
    cache, hot, slots, rows, w = _inputs("mixed")
    slots[0, 0] = K + C                     # bad slot
    slots[3, 1], rows[3, 1] = fused.MISS, R  # bad row at a MISS
    got = fused.fused_warm_lookup_plain(
        torch.from_numpy(cache), slots, rows, None,
        torch.from_numpy(hot), num_rows=R)
    nan_bags = torch.isnan(got).all(dim=1)
    assert nan_bags.tolist() == [b in (0, 3) for b in range(slots.shape[0])]
    miss_rows, miss_pos = fused._miss_list_from_slots(slots, rows, R)
    assert 3 * slots.shape[1] + 1 not in miss_pos
    assert R not in miss_rows
    all_rows, all_pos = fused._miss_list_from_slots(slots, rows)
    assert all_pos.size == miss_pos.size + 1


def test_tables_at_once_equal_per_table_plain():
    """`fused_warm_lookup_tables` on the CPU is the plain version of each
    table: [T, C, D] / [B, T, L] in, raw sums and per-table lists out."""
    T = 3
    parts = [_inputs("pad", seed=t) for t in range(T)]
    cache = torch.from_numpy(np.stack([p[0] for p in parts]))
    hot = torch.from_numpy(np.stack([p[1] for p in parts]))
    slots = torch.from_numpy(np.stack([p[2] for p in parts], axis=1))
    rows = torch.from_numpy(np.stack([p[3] for p in parts], axis=1))
    before = fused.LAUNCHES, kernel.LAUNCHES
    pooled, miss_rows, miss_pos = fused.fused_warm_lookup_tables(
        cache, slots, rows, None, hot, num_rows=R)
    assert (fused.LAUNCHES, kernel.LAUNCHES) == before
    for t in range(T):
        want = _port(*[np.asarray(x) for x in parts[t][:4]], None, "sum")
        np.testing.assert_array_equal(pooled[:, t].numpy(),
                                      want.pooled.numpy())
        np.testing.assert_array_equal(miss_rows[t], want.miss_rows)
        np.testing.assert_array_equal(miss_pos[t], want.miss_pos)


def test_cuda_backend_refuses_cpu_tensors():
    cache, hot, slots, rows, w = _inputs("mixed")
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_warm_lookup(torch.from_numpy(cache), slots, rows,
                                backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fused.launch_tables(torch.from_numpy(cache)[None],
                      torch.from_numpy(slots)[:, None].contiguous(),
                      torch.from_numpy(rows)[:, None].contiguous(), None,
                      None, R, fused.FusedLookupOpts())
    with pytest.raises(ValueError, match="unknown backend"):
        fused.fused_warm_lookup(torch.from_numpy(cache), slots, rows,
                                backend="xla")


def test_mean_epilogue_is_a_true_division():
    """The epilogue divides by L as a tensor operand: the same quotient as
    the embedding-bag kernel's in-kernel division, never a reciprocal
    multiply."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(64, 7)).astype(np.float32))
    got = fused.mean_epilogue(x, None, 150, "mean")
    want = (x.double() / 150).float()       # correctly rounded quotient
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="unknown mode"):
        fused.mean_epilogue(x, None, 3, "max")


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True),
                                           ("mean", False)])
def test_device_warm_cache_lookup_fused(mode, weighted):
    """Cache-level fused lookup (mirrors tests/test_kernel_fused.py's case
    of this name): hits from the payload, misses on the list, no counter
    moves (read-only like probe()); slot map and lists equal the JAX
    cache's, pooled values within the bound of its XLA route."""
    from repro.ps.warm_cache import DeviceWarmCache as JCache
    from repro_torch.ps.warm_cache import DeviceWarmCache, WarmCache
    assert not WarmCache(4, 8).supports_fused
    cache, jcache = DeviceWarmCache(capacity=8, dim=8, device="cpu"), \
        JCache(capacity=8, dim=8)
    assert cache.supports_fused
    rng = np.random.default_rng(41)
    table = rng.normal(size=(32, 8)).astype(np.float32)
    resident = np.array([3, 5, 7, 11])
    for c in (cache, jcache):
        c.admit(resident, table[resident], np.ones(4, np.int64))
    before = cache.stats()
    rows = np.array([[3, 5, 9], [11, 20, 3]])
    w = rng.random(rows.shape).astype(np.float32) if weighted else None
    got = cache.lookup_fused(rows, w, mode=mode)
    want = jcache.lookup_fused(rows, None if w is None else jnp.asarray(w),
                               mode=mode, backend="xla")
    assert cache.stats() == before == jcache.stats()
    slots = cache.build_slot_map(rows)
    np.testing.assert_array_equal(slots, jcache.build_slot_map(rows))
    np.testing.assert_array_equal(got.miss_rows, [9, 20])
    np.testing.assert_array_equal(got.miss_pos, [2, 4])
    np.testing.assert_array_equal(got.miss_rows, want.miss_rows)
    np.testing.assert_array_equal(got.miss_pos, want.miss_pos)
    # the bound over the rows each bag adds: misses add a zero row
    eff = torch.cat([cache.data, torch.zeros(1, 8)])
    s = torch.from_numpy(slots)
    idx = torch.where(s >= 0, s, torch.full_like(s, 8))
    _assert_within(got.pooled, want.pooled, ref.summation_bound(
        eff, idx, None if w is None else torch.from_numpy(w), mode))
    masked = table[rows] * (1.0 if w is None else w[..., None])
    masked[np.isin(rows, resident, invert=True)] = 0.0
    if mode == "sum":            # the port's own dense pooling, bit for bit
        assert torch.equal(got.pooled,
                           torch.from_numpy(masked).sum(dim=1))
