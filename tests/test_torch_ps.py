"""The port's parameter server against the TPU path's, on the CPU.

Both servers get the same numpy tables, plans and batches. After the same
sequence of calls the host state must be EXACTLY equal: the counters in
`stats()`, the warm tag stores (`slot_row`, `slot_freq`, `slot_tick`,
`loc`), the staged batches, and the rows `lookup()` returns (pure gathers).
Pooled output of `lookup_fused` agrees within the summation bound
(`ref.summation_bound` on the dense rows), since the two frameworks sum in
other orders; the port's own pooled output equals its dense pooling bit
for bit. The async prefetch worker is waited for after each `stage()`, so
the overlap counters do not depend on thread timing.
"""
import numpy as np
import pytest
import torch

from repro.ps import ParameterServer as JServer
from repro.ps import PSConfig as JConfig
from repro_torch.core.embedding import _pool_rows_core
from repro_torch.kernels.embedding_bag import ref
from repro_torch.ps import ParameterServer, PSConfig

T, R, D, L, B = 3, 400, 8, 6, 11
FLOAT_KEYS = ("degraded_l2_sq", "degraded_l2_delta")
TIMING_KEYS = ("consume_wait_s",)


def _tables(seed=0):
    return np.random.default_rng(seed).normal(size=(T, R, D)).astype(
        np.float32)


def _batches(n, seed=1):
    """Zipf-ish traffic so the hot and warm tiers see reuse."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.3, size=(n, B, T, L)) - 1, R - 1)
    perm = rng.permutation(R)
    return [perm[ranks[i]].astype(np.int32) for i in range(n)]


def _pair(seed=0, **cfg):
    tables = _tables(seed)
    trace = _batches(2, seed=seed + 10)
    trace = np.concatenate(trace)
    j = JServer(tables, JConfig(**cfg), trace=trace)
    p = ParameterServer(tables, PSConfig(**cfg), trace=trace, device="cpu")
    return j, p, tables


def _settle(*servers):
    """Wait for the async prefetch worker to finish every staged job."""
    for s in servers:
        for job in list(getattr(s.prefetch, "_jobs", ())):
            assert job.ready.wait(10)


def _assert_same_state(j, p):
    js, ps = j.stats(), p.stats()
    assert set(js) == set(ps)
    for k in js:
        if k in TIMING_KEYS:
            continue
        if k in FLOAT_KEYS:
            assert ps[k] == pytest.approx(js[k], rel=1e-12, abs=1e-12), k
        else:
            assert ps[k] == js[k], k
    for jw, pw in zip(j.warm, p.warm):
        np.testing.assert_array_equal(pw.slot_row, jw.slot_row)
        np.testing.assert_array_equal(pw.slot_freq, jw.slot_freq)
        np.testing.assert_array_equal(pw.slot_tick, jw.slot_tick)
        assert pw.loc == jw.loc
        assert (pw.hits, pw.misses, pw.evictions, pw.insertions) == \
            (jw.hits, jw.misses, jw.evictions, jw.insertions)
    assert p.num_hot == j.num_hot
    assert [list(w.ravel()) for w in p.window] == \
        [list(w.ravel()) for w in j.window]
    assert len(p.prefetch) == len(j.prefetch)


def _pooled_check(p_out, rows, combine):
    """The port's fused output vs its dense pooling of the same rows: bit
    for bit."""
    want = _pool_rows_core(torch.from_numpy(rows), None, combine)
    np.testing.assert_array_equal(p_out.numpy(), want.numpy())


def _run(j, p, batches, fused, tables, combine="sum"):
    for idx in batches:
        if fused:
            jo = np.asarray(j.lookup_fused(idx, combine=combine))
            po = p.lookup_fused(idx, combine=combine)
            dense = tables[np.arange(T)[None, :, None], idx]
            _pooled_check(po, dense, combine)
            bound = torch.stack([ref.summation_bound(
                torch.from_numpy(tables[t]), torch.from_numpy(idx[:, t]),
                None, combine) for t in range(T)], 1)
            assert bool(((po - torch.from_numpy(jo)).abs() <= bound).all())
        else:
            np.testing.assert_array_equal(p.lookup(idx), j.lookup(idx))
    _assert_same_state(j, p)


CONFIGS = {
    "host-lfu-sync": dict(hot_rows=20, warm_slots=30, warm_backing="host"),
    "host-lru-async": dict(hot_rows=20, warm_slots=30, eviction="lru",
                           async_prefetch=True),
    "device-lfu-sync": dict(hot_rows=20, warm_slots=30,
                            warm_backing="device"),
    "device-fused-lfu-async": dict(hot_rows=20, warm_slots=30,
                                   warm_backing="device", fused_lookup=True,
                                   async_prefetch=True),
    "device-fused-lru-nohot": dict(hot_rows=0, warm_slots=25,
                                   eviction="lru", warm_backing="device",
                                   fused_lookup=True),
    "device-fused-depth0": dict(hot_rows=20, warm_slots=30,
                                warm_backing="device", fused_lookup=True,
                                prefetch_depth=0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serving_sequence_matches_jax(name):
    """Lookups, staging (consumed and stale), padding hints and a refresh,
    over five batches: the same counters, tag stores and staged queue."""
    cfg = CONFIGS[name]
    fused = cfg.get("fused_lookup", False)
    j, p, tables = _pair(**cfg)
    batches = _batches(5, seed=2)
    try:
        _run(j, p, batches[:1], fused, tables)
        for s in (j, p):
            s.stage(batches[1])
            s.stage(batches[3])        # staged, consumed two batches later
        _settle(j, p)
        _assert_same_state(j, p)
        _run(j, p, batches[1:3], fused, tables)
        # a padded batch: only its first 4 queries are traffic
        for s in (j, p):
            s.hint_valid(4)
        _run(j, p, batches[3:4], fused, tables)
        assert j.refresh() == p.refresh()
        _run(j, p, batches[4:], fused, tables)
        j.flush()
        p.flush()
        _assert_same_state(j, p)
    finally:
        j.close()
        p.close()


@pytest.mark.parametrize("fused", [False, True])
def test_degraded_mode_matches_jax(fused):
    cfg = dict(hot_rows=20, warm_slots=30, warm_backing="device",
               fused_lookup=fused)
    j, p, tables = _pair(**cfg)
    batches = _batches(3, seed=3)
    _run(j, p, batches[:1], fused, tables)
    for s in (j, p):
        assert s.set_degraded(True) and s.degraded()
        assert not s.can_stage() and not s.stage(batches[2])
        if fused:
            s.lookup_fused(batches[1])
        else:
            s.lookup(batches[1])
    _assert_same_state(j, p)
    assert p.stats()["degraded_rows"] > 0
    for s in (j, p):
        s.set_degraded(False)
    _run(j, p, batches[2:], fused, tables)


@pytest.mark.parametrize("fused", [False, True])
def test_resize_and_retune_match_jax(fused):
    cfg = dict(hot_rows=20, warm_slots=30, warm_backing="device",
               fused_lookup=fused)
    j, p, tables = _pair(**cfg)
    batches = _batches(4, seed=4)
    _run(j, p, batches[:2], fused, tables)
    j.resize_tiers(10, 45)
    p.resize_tiers(10, 45)
    assert p._warm_payload.shape == (T, 45, D)
    assert all(w.data.data_ptr() == p._warm_payload[t].data_ptr()
               for t, w in enumerate(p.warm))
    _run(j, p, batches[2:3], fused, tables)
    budget = 2 * T * D * 4 * 40
    assert j.retune(budget) == p.retune(budget)
    assert (p.cfg.hot_rows, p.cfg.warm_slots) == (j.cfg.hot_rows,
                                                  j.cfg.warm_slots)
    _run(j, p, batches[3:], fused, tables)
    assert ParameterServer(tables, PSConfig(), device="cpu").retune(
        budget) is None


@pytest.mark.parametrize("fused", [False, True])
def test_update_commit_and_abort_match_jax(fused):
    cfg = dict(hot_rows=20, warm_slots=30, warm_backing="device",
               fused_lookup=fused, async_prefetch=True)
    j, p, tables = _pair(**cfg)
    batches = _batches(4, seed=5)
    try:
        _run(j, p, batches[:2], fused, tables)
        hot_row = int(p.plans[1].perm[0])
        rows = np.unique(np.concatenate([batches[1][:, 1].ravel()[:10],
                                         [hot_row]]))
        vals = np.random.default_rng(6).normal(
            size=(rows.size, D)).astype(np.float32)
        for s in (j, p):
            s.stage(batches[2])
            assert s.begin_update(1)
            s.apply_update(1, rows, vals)
            assert s.abort_update(1)
            assert s.begin_update(2)
            s.apply_update(1, rows, vals)
        _settle(j, p)
        assert j.commit_update(2) == p.commit_update(2)
        assert p.version() == 2
        tables[1, rows] = vals
        np.testing.assert_array_equal(p.cold.tables, tables)
        np.testing.assert_array_equal(p._hot_dev[1][0].numpy(),
                                      vals[rows == hot_row][0])
        _run(j, p, batches[2:], fused, tables)
        with pytest.raises(ValueError, match="monotonic"):
            p.begin_update(1)
        with pytest.raises(RuntimeError, match="begin_update"):
            p.commit_update(3)
    finally:
        j.close()
        p.close()


def test_tables_are_adopted_not_copied():
    """The cold tier is the caller's array (or host tensor) itself."""
    tables = _tables()
    host = torch.from_numpy(tables.copy())
    for t in (tables, host):
        p = ParameterServer(t, PSConfig(hot_rows=5, warm_slots=5),
                            device="cpu")
        ptr = (t.data_ptr() if torch.is_tensor(t)
               else t.__array_interface__["data"][0])
        assert p.cold.tables.__array_interface__["data"][0] == ptr


def test_norms_per_table_equal_the_reference():
    from repro.ps import ColdStore as JCold
    from repro_torch.ps import ColdStore
    tables = _tables(7)
    j, p = JCold(tables), ColdStore(tables)
    for t in range(T):
        np.testing.assert_allclose(p.row_norms_sq(t), j.row_norms_sq(t),
                                   rtol=1e-12)
    p.update_rows(0, np.array([3]), np.ones((1, D), np.float32))
    assert p.row_norms_sq(0)[3] == D


def test_degraded_norms_read_only_the_zero_filled_rows():
    """The first degraded lookup computes the norms of the rows it
    zero-fills, not of whole tables; an update forgets only the rows it
    wrote."""
    j, p, tables = _pair(hot_rows=20, warm_slots=30)
    for s in (j, p):
        s.set_degraded(True)
    idx = _batches(1, seed=5)[0]
    j.lookup(idx)
    p.lookup(idx)
    norms = p.cold._norms_sq
    known = sum(int((~np.isnan(n)).sum()) for n in norms.values())
    assert 0 < known < T * R
    assert known == p.stats()["cold_misses"]      # distinct misses, once
    assert p.stats()["degraded_l2_sq"] == pytest.approx(
        j.stats()["degraded_l2_sq"], rel=1e-12)
    t = next(iter(norms))
    rows = np.flatnonzero(~np.isnan(norms[t]))
    p.cold.update_rows(t, rows[:1], np.ones((1, D), np.float32))
    assert np.isnan(norms[t][rows[0]])
    assert not np.isnan(norms[t][rows[1:]]).any()
    assert p.cold.row_norms_sq(t, rows[:1])[0] == D


def test_fused_needs_device_backing():
    with pytest.raises(ValueError, match="warm_backing='device'"):
        PSConfig(fused_lookup=True)
    p = ParameterServer(_tables(), PSConfig(warm_slots=4), device="cpu")
    assert not p.supports_fused()
    with pytest.raises(RuntimeError, match="lookup_fused needs"):
        p.lookup_fused(_batches(1)[0])
    with pytest.raises(ValueError, match="unknown combine"):
        ParameterServer(_tables(), PSConfig(
            warm_slots=4, warm_backing="device", fused_lookup=True),
            device="cpu").lookup_fused(_batches(1)[0], combine="max")


@pytest.mark.parametrize("rows", [0, 5, 3000])
def test_cold_gathers_land_in_buffers_of_their_own(rows):
    """`take_rows` is numpy's fancy indexing; from 1 MiB up the result
    lives in an anonymous mapping of its own (freed, it leaves the
    process), below that in an ordinary array."""
    import mmap

    from repro_torch.ps.cold_store import ColdStore, take_rows
    src = np.random.default_rng(0).normal(size=(5000, 128)).astype(
        np.float32)
    idx = np.random.default_rng(1).integers(0, 5000, rows)
    got = take_rows(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    base = got
    while isinstance(base, np.ndarray) and base.base is not None:
        base = base.base
    base = base.obj if isinstance(base, memoryview) else base
    assert isinstance(base, mmap.mmap) == (got.nbytes >= 1 << 20)
    cold = ColdStore(src[None])
    np.testing.assert_array_equal(cold.gather(0, idx), src[idx])
    assert cold.gathered_rows == rows
