"""The port's embedding-bag module (plain path on the CPU) against the TPU path.

The same numpy inputs go through `repro.kernels.embedding_bag` (`ref` and
`ops.embedding_bag(backend="xla")`; the Pallas legs do not run on this
JAX) and through `repro_torch.kernels.embedding_bag.ops` on CPU tensors,
which take the plain version. Pooled floats are held to the summation
bound |port - ref| <= 2·eps_f32·Σ|w·x| per output element (carried through
the mean's division, `ref.summation_bound`); integer results match
exactly. The CUDA kernel itself is held to the same bound on the card by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hot_cache as jhot
from repro.kernels.embedding_bag import ops as jops
from repro.kernels.embedding_bag import ref as jref
from repro_torch.core import hot_cache
from repro_torch.kernels.embedding_bag import fused, kernel, ops, ref

ROWS, DIM, POOL, BATCH = 1000, 16, 8, 13   # B=13: no block size divides it


def _inputs(seed, weighted, rows=ROWS, dim=DIM, pool=POOL, batch=BATCH):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    idx = rng.integers(0, rows, size=(batch, pool)).astype(np.int32)
    w = rng.random((batch, pool)).astype(np.float32) if weighted else None
    return table, idx, w


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _within_bound(port, want, table, idx, w, mode):
    bound = ref.summation_bound(_t(table), _t(idx), _t(w), mode).numpy()
    err = np.abs(port.numpy() - np.asarray(want))
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("num_hot", [0, 64])
def test_embedding_bag_matches_jax(mode, weighted, num_hot):
    table, idx, w = _inputs(0, weighted)
    if num_hot:
        # hot-first tables with remapped indices, as the collection stores
        trace = np.random.default_rng(1).zipf(1.3, 4000) % ROWS
        plan = jhot.plan_from_trace(trace, ROWS, num_hot)
        table, idx = plan.reorder_table(table), plan.remap_indices(idx)
    opts = kernel.EmbeddingBagOpts(num_hot=num_hot)
    port = ops.embedding_bag(_t(table), _t(idx), _t(w), mode=mode,
                             backend="auto", opts=opts)
    assert port.shape == (BATCH, DIM) and port.dtype == torch.float32
    jw = None if w is None else jnp.asarray(w)
    for want in (jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                        jw, mode=mode),
                 jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx), jw,
                                    mode=mode, backend="xla")):
        _within_bound(port, want, table, idx, w, mode)


def test_embedding_bag_bf16_table_matches_jax():
    """bf16 tables: the plain version rounds where the reference does
    (weights cast to the table dtype, output in it); held to one bf16
    rounding of the result beside the f32 bound."""
    table, idx, w = _inputs(2, True)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    port = ops.embedding_bag(t16, _t(idx), _t(w), mode="sum")
    assert port.dtype == torch.bfloat16
    want = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(idx), jnp.asarray(w)),
        np.float32)
    bound = ref.summation_bound(t16.float(), _t(idx), _t(w)).numpy()
    err = np.abs(port.float().numpy() - want)
    assert (err <= bound + 2.0 ** -7 * np.abs(want)).all()


def test_embedding_lookup_matches_jax_exactly():
    table, _, _ = _inputs(3, False)
    tok = np.random.default_rng(4).integers(0, ROWS, size=(3, 5, 2))
    port = ops.embedding_lookup(_t(table), torch.from_numpy(tok))
    assert port.shape == (3, 5, 2, DIM)
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jref.embedding_lookup_ref(
            jnp.asarray(table), jnp.asarray(tok))))
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jops.embedding_lookup(
            jnp.asarray(table), jnp.asarray(tok), backend="xla")))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ragged_ref_matches_jax(mode, weighted):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    offsets = np.array([0, 3, 3, 10, 11, 20], np.int32)   # one empty bag
    flat = rng.integers(0, ROWS, size=offsets[-1]).astype(np.int32)
    w = rng.random(offsets[-1]).astype(np.float32) if weighted else None
    port = ref.embedding_bag_ragged_ref(_t(table), _t(flat), _t(offsets),
                                        _t(w), mode=mode)
    want = jref.embedding_bag_ragged_ref(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(offsets),
        None if w is None else jnp.asarray(w), mode=mode)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_weighted_mean_divides_by_weight_sum():
    """The kernel's weighted mean (and so the plain version's) divides by
    max(Σw, 1e-9), an all-zero-weight bag included."""
    table, idx, w = _inputs(6, True)
    w[0] = 0.0
    port = ops.embedding_bag(_t(table), _t(idx), _t(w), mode="mean").numpy()
    want = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), mode="mean"))
    _within_bound(torch.from_numpy(port), want, table, idx, w, "mean")
    np.testing.assert_array_equal(port[0], 0.0)


def test_cuda_backend_on_cpu_tensor_raises():
    table, idx, _ = _inputs(7, False)
    with pytest.raises(ValueError, match="CUDA"):
        ops.embedding_bag(_t(table), _t(idx), backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.embedding_lookup(_t(table), _t(idx), backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.embedding_bag_cuda(_t(table)[None], _t(idx)[:, None])
    with pytest.raises(ValueError, match="unknown backend"):
        ops.embedding_bag(_t(table), _t(idx), backend="xla")


def test_auto_on_cpu_takes_plain_path_without_launching():
    table, idx, w = _inputs(8, True)
    before = kernel.LAUNCHES
    ops.embedding_bag(_t(table), _t(idx), _t(w), mode="mean")
    ops.embedding_lookup(_t(table), _t(idx))
    assert kernel.LAUNCHES == before == 0


def test_opts_register_bytes():
    """The launch geometry's accounting, which replaced the register-ring
    byte count: the ring lives in shared memory, one warp per bag."""
    opts = kernel.EmbeddingBagOpts(prefetch_distance=8, batch_block=8)
    # D=128 f32, unweighted: per warp an 8-slot ring of 512-byte rows and
    # 64 staged row addresses
    assert opts.shared_bytes(dim=128) == 8 * (8 * 512 + 64 * 8)
    # weighted bags also stage 64 weights a warp
    assert opts.shared_bytes(dim=128, weighted=True) == 8 * (
        8 * 512 + 64 * 8 + 64 * 4)
    # a row wider than 512 bytes reuses the same ring in several passes
    assert opts.shared_bytes(dim=256) == opts.shared_bytes(dim=128)
    # the scalar path (row bytes not a multiple of 16) has no ring
    assert opts.shared_bytes(dim=33) == 8 * 64 * 8
    # the default ring (depth 4); bf16 rows of 128 bytes take the ring,
    # bf16 rows of 72 bytes do not
    small = kernel.EmbeddingBagOpts(batch_block=2)
    assert small.ring_depth() == 4
    assert small.shared_bytes(64, 2) == 2 * (4 * 512 + 64 * 8)
    assert small.shared_bytes(36, 2) == 2 * 64 * 8


@pytest.mark.parametrize("requested,depth", [
    (1, 2), (2, 2), (3, 2), (4, 4), (5, 4), (8, 8), (15, 8), (16, 16),
    (40, 16)])
def test_ring_depth_clamp(requested, depth):
    """The kernels take the largest power of two <= prefetch_distance,
    clamped to [2, 16]; the accounting follows the depth taken."""
    opts = kernel.EmbeddingBagOpts(prefetch_distance=requested)
    assert opts.ring_depth() == depth
    assert opts.shared_bytes(128) == 8 * (depth * 512 + 64 * 8)


@pytest.mark.parametrize("bad", [
    dict(batch_block=0), dict(batch_block=9), dict(prefetch_distance=0),
    dict(prefetch_distance=-4)])
def test_wrappers_refuse_options_beyond_limits(bad):
    """Both CUDA wrappers check their options before anything is launched
    (here, before they even look at the device)."""
    table, idx, _ = _inputs(11, False)
    with pytest.raises(ValueError, match="batch_block|prefetch_distance"):
        kernel.embedding_bag_cuda(_t(table)[None], _t(idx)[:, None],
                                  opts=kernel.EmbeddingBagOpts(**bad))
    slots = _t(idx)[:, None].contiguous()
    with pytest.raises(ValueError, match="batch_block|prefetch_distance"):
        fused.launch_tables(_t(table)[None], slots, slots, None, None, ROWS,
                            fused.FusedLookupOpts(**bad))
    assert kernel.LAUNCHES == fused.LAUNCHES == 0


def test_hot_plan_remap_on_tensors_matches_numpy():
    trace = np.random.default_rng(9).integers(0, ROWS, 5000)
    plan = hot_cache.plan_from_trace(trace, ROWS, 50)
    table, idx, _ = _inputs(10, False)
    np.testing.assert_array_equal(plan.remap_indices(_t(idx)).numpy(),
                                  plan.remap_indices(idx))
    np.testing.assert_array_equal(plan.reorder_table(_t(table)).numpy(),
                                  plan.reorder_table(table))
