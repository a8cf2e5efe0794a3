"""The port's checkpoints and online model updates against the JAX
package's.

`repro_torch.checkpoint` writes the reference's on-disk layout, so a
stream or a step published by either package is read by the other with
identical records and arrays (exact). The update transaction of the
`device` and `tiered` backends serves the old version bit for bit until
commit and the new one after (held against the port's dense path, the
law), and the session's epoch guard pins each query to its admission
version: every batch is single-version and each answer equals the port's
dense oracle at that version bit for bit, and the JAX session's answer
on the same update stream within `rtol=1e-4, atol=1e-5` (sum and
unweighted mean only: ROADMAP.md Queue 3).
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import ModelUpdateStream as JStream
from repro.core import EmbeddingBagCollection as JEBC
from repro.core.embedding import EmbeddingStageConfig as JStage
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro.ps import PSConfig as JPSConfig
from repro_torch import serving
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    ModelUpdateStream)
from repro_torch.convert import load_reference_params
from repro_torch.core import make_pattern
from repro_torch.core.embedding import (EmbeddingBagCollection,
                                        EmbeddingStageConfig,
                                        _pool_rows_core)
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import PSConfig

ROWS, TABLES, DIM, POOL = 256, 6, 16, 6
SKEWED = ("one_item", "one_item", "high_hot", "med_hot", "random", "random")
TOL = dict(rtol=1e-4, atol=1e-5)


def _pats(hotness=SKEWED):
    return [make_pattern(h, ROWS, seed=t) for t, h in enumerate(hotness)]


def _batch(pats, batch, seed):
    return np.stack([p.sample(batch, POOL, seed=seed * 100 + t)
                     for t, p in enumerate(pats)], axis=1).astype(np.int32)


def _delta(rng, tables, n_tables=2, n_rows=5):
    """Random changed-rows payload + the updated oracle snapshot."""
    changed, want = {}, tables.copy()
    for t in rng.choice(TABLES, size=n_tables, replace=False):
        rows = rng.choice(ROWS, size=n_rows, replace=False)
        vals = rng.normal(size=(n_rows, DIM)).astype(np.float32)
        changed[int(t)] = (rows, vals)
        want[int(t), rows] = vals
    return changed, want


def _assert_same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert {k: ra[k] for k in ("version", "kind", "base", "shape",
                                   "dtype")} == \
            {k: rb[k] for k in ("version", "kind", "base", "shape",
                                "dtype")}
        assert sorted(ra["tables"]) == sorted(rb["tables"])
        for t in ra["tables"]:
            for x, y in zip(ra["tables"][t], rb["tables"][t]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the on-disk layout is shared with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("publisher", ["port", "jax"])
def test_update_stream_read_by_either_package(tmp_path, publisher):
    rng = np.random.default_rng(0)
    tables = rng.normal(size=(TABLES, ROWS, DIM)).astype(np.float32)
    pub = (ModelUpdateStream if publisher == "port" else JStream)(
        str(tmp_path), full_fallback_ratio=0.3)
    readers = (ModelUpdateStream(str(tmp_path)), JStream(str(tmp_path)))
    assert pub.publish_full(torch.from_numpy(tables)
                            if publisher == "port" else tables) == 1
    changed, want = _delta(rng, tables)
    assert pub.publish_delta(changed) == 2
    # a delta touching most rows lands as a full snapshot
    big = {0: (np.arange(ROWS), rng.normal(size=(ROWS, DIM)).astype(
        np.float32)), 1: (np.arange(ROWS), rng.normal(
            size=(ROWS, DIM)).astype(np.float32))}
    assert pub.publish_delta(big) == 3
    recs = [r.poll() for r in readers]
    assert [r["kind"] for r in recs[0]] == ["full", "delta", "full"]
    _assert_same_records(*recs)
    assert all(r.poll() == [] for r in readers)
    for mgr in (CheckpointManager(str(tmp_path)), JManager(str(tmp_path))):
        np.testing.assert_array_equal(mgr.load_version(2), want)
        assert mgr.latest_version() == 3
    np.testing.assert_array_equal(
        CheckpointManager(str(tmp_path)).load_version(3),
        JManager(str(tmp_path)).load_version(3))


def test_version_guards(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tables = np.zeros((TABLES, ROWS, DIM), np.float32)
    with pytest.raises(CheckpointError, match="base snapshot"):
        mgr.save_delta(1, {0: (np.array([0]), np.zeros((1, DIM),
                                                          np.float32))})
    mgr.save_version(1, tables)
    with pytest.raises(CheckpointError, match="monotonic"):
        mgr.save_version(1, tables)
    with pytest.raises(CheckpointError, match="dtype"):
        mgr.save_delta(2, {0: (np.array([0]), np.zeros((1, DIM)))})
    with pytest.raises(CheckpointError, match="rows outside"):
        mgr.save_delta(2, {0: (np.array([ROWS]), np.zeros(
            (1, DIM), np.float32))})
    with pytest.raises(CheckpointError, match=r"\[T, R, D\]"):
        mgr.save_version(2, tables[0])
    assert mgr.latest_version() == 1


# ---------------------------------------------------------------------------
# bfloat16: updates and checkpoints carry the 16-bit patterns
# ---------------------------------------------------------------------------

def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _bf16_ebcs(bits):
    """(JAX device collection + its params, port device collection) over
    the same bf16 tables."""
    geo = dict(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
               dtype="bfloat16")
    jebc = JEBC(JStage(**geo, backend="xla"))
    params = {"tables": jnp.asarray(bits.view(ml_dtypes.bfloat16))}
    jebc.storage.build(params)
    ebc = EmbeddingBagCollection(
        EmbeddingStageConfig(**geo), device="cpu",
        tables=torch.from_numpy(bits.copy()).view(torch.bfloat16))
    return jebc, params, ebc


def _assert_same_npy(a, b):
    """Two files hold the same array (dtype and bytes) or, for manifests,
    the same leaves' dtypes and shapes. (The JAX package's header says
    `<V2` where numpy alone writes `|V2`; both load as `|V2`.)"""
    if a.suffix == ".json":
        ja, jb = json.loads(a.read_text()), json.loads(b.read_text())
        assert ja.get("leaves", ja.get("dtype")) == \
            jb.get("leaves", jb.get("dtype"))
        return
    x, y = np.load(a), np.load(b)
    assert x.dtype == y.dtype and x.shape == y.shape, a.name
    assert x.tobytes() == y.tobytes(), a.name


def test_bf16_update_applied_by_both_packages_gives_the_same_bits():
    rng = np.random.default_rng(5)
    bits = _bf16(rng.normal(size=(TABLES, ROWS, DIM))).view(np.int16)
    jebc, params, ebc = _bf16_ebcs(bits)
    st = ebc.storage
    for v in (1, 2):
        changed, _ = _delta(rng, bits.view(ml_dtypes.bfloat16))
        jebc.storage.begin_update(v)
        st.begin_update(v)
        for t, (rows, vals) in changed.items():
            vals = _bf16(vals)
            jebc.storage.apply_update(t, rows, vals)
            # a bf16 tensor, then the JAX package's own numpy form
            st.apply_update(t, rows, torch.from_numpy(
                vals.view(np.int16)).view(torch.bfloat16) if v == 1
                else vals)
        jebc.storage.commit_update(v)
        assert st.commit_update(v)["version"] == v
        np.testing.assert_array_equal(
            ebc.tables.view(torch.int16).numpy(),
            np.asarray(params["tables"]).view(np.int16))
    st.begin_update(3)
    with pytest.raises(ValueError, match="bfloat16"):
        st.apply_update(0, np.array([0]), np.zeros((1, DIM), np.float32))


def test_bf16_chain_written_by_jax_reads_in_port_with_the_same_bits(
        tmp_path):
    """A bf16 full + delta chain the JAX package wrote (its `|V2` files):
    the port reads the same bits, and its records update a bf16 table to
    the chain's snapshot. The port writes the same files back."""
    rng = np.random.default_rng(6)
    tables = _bf16(rng.normal(size=(TABLES, ROWS, DIM)))
    jm = JManager(str(tmp_path / "jax"))
    jm.save_version(1, tables)
    changed, want = _delta(rng, tables)
    jm.save_delta(2, {t: (r, _bf16(v)) for t, (r, v) in changed.items()})
    mgr = CheckpointManager(str(tmp_path / "jax"))
    want_bits = _bf16(want).view(np.int16)
    got = mgr.load_version(2)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want_bits)
    np.testing.assert_array_equal(mgr.load_version(1),
                                  tables.view(np.int16))
    recs = [mgr.load_update(v) for v in (1, 2)]
    assert [r["dtype"] for r in recs] == ["bfloat16", "bfloat16"]
    _, _, ebc = _bf16_ebcs(np.zeros_like(want_bits))
    for rec in recs:
        ebc.storage.begin_update(rec["version"])
        for t, (rows, vals) in rec["tables"].items():
            ebc.storage.apply_update(t, rows, vals)
        ebc.storage.commit_update(rec["version"])
    np.testing.assert_array_equal(ebc.tables.view(torch.int16).numpy(),
                                  want_bits)
    # the port writes the chain as the JAX package does: the same files
    pm = CheckpointManager(str(tmp_path / "port"))
    pm.save_version(1, torch.from_numpy(tables.view(np.int16)).view(
        torch.bfloat16))
    pm.save_delta(2, {t: (r, torch.from_numpy(_bf16(v).view(np.int16))
                          .view(torch.bfloat16))
                      for t, (r, v) in changed.items()})
    for v in (1, 2):
        for name in os.listdir(tmp_path / "jax" / f"v_{v:09d}"):
            a = tmp_path / "jax" / f"v_{v:09d}" / name
            b = tmp_path / "port" / f"v_{v:09d}" / name
            if name == "manifest.json":
                assert json.loads(a.read_text()) == json.loads(
                    b.read_text())
            else:
                _assert_same_npy(a, b)
    # a delta touching most rows lands as a full bf16 snapshot
    big = {0: (np.arange(ROWS), _bf16(rng.normal(size=(ROWS, DIM))))}
    pm.save_delta(3, big, full_fallback_ratio=0.1)
    assert pm.load_version_manifest(3)["dtype"] == "bfloat16"
    want_bits[0] = big[0][1].view(np.int16)
    np.testing.assert_array_equal(pm.load_version(3), want_bits)


def test_bf16_step_round_trip_and_jax_step_in_port(tmp_path):
    """A bf16 step: the port writes the file the JAX package writes, and
    restores the JAX package's step as bf16 tensors with the same bits."""
    bits = _bf16(np.random.default_rng(7).normal(
        size=(TABLES, ROWS, DIM))).view(np.int16)
    sd = {"ebc.tables": torch.from_numpy(bits).view(torch.bfloat16),
          "bottom.w0": torch.ones(4, 16)}
    JManager(str(tmp_path / "jax")).save(1, {
        "ebc": {"tables": jnp.asarray(bits.view(ml_dtypes.bfloat16))},
        "bottom": {"w0": jnp.ones((4, 16))}})
    CheckpointManager(str(tmp_path / "port")).save(1, sd)
    for name in ("arr_00000.npy", "arr_00001.npy", "manifest.json"):
        _assert_same_npy(tmp_path / "jax" / "step_000000001" / name,
                         tmp_path / "port" / "step_000000001" / name)
    for root in ("jax", "port"):
        out, _ = CheckpointManager(str(tmp_path / root)).restore(sd)
        assert out["ebc.tables"].dtype == torch.bfloat16
        assert torch.equal(out["ebc.tables"].view(torch.int16),
                           sd["ebc.tables"].view(torch.int16))
        assert torch.equal(out["bottom.w0"], sd["bottom.w0"])


def _jax_params(seed=0):
    jmodel = JDLRM(JConfig(embedding=JStage(
        num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL, backend="xla"),
        dense_features=4, bottom_mlp=(16, DIM), top_mlp=(8, 1)))
    return jmodel.init(jax.random.PRNGKey(seed))


def _port_model(storage="device", combine="sum", seed=0):
    return DLRM(DLRMConfig(embedding=EmbeddingStageConfig(
        num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
        combine=combine, storage=storage), dense_features=4,
        bottom_mlp=(16, DIM), top_mlp=(8, 1)), device="cpu", seed=seed)


def test_step_written_by_port_restores_in_jax(tmp_path):
    model = _port_model()
    CheckpointManager(str(tmp_path)).save(7, model.state_dict(),
                                          extra={"note": "port"})
    tree, extra = JManager(str(tmp_path)).restore(_jax_params(), step=7)
    assert extra == {"note": "port"}
    sd = model.state_dict()
    for tower in ("bottom", "top"):
        for name, leaf in tree[tower].items():
            np.testing.assert_array_equal(np.asarray(leaf),
                                          sd[f"{tower}.{name}"].numpy())
    np.testing.assert_array_equal(np.asarray(tree["embedding"]["tables"]),
                                  sd["ebc.tables"].numpy())


def test_step_written_by_jax_restores_in_port(tmp_path):
    params = _jax_params(seed=3)
    jm = JManager(str(tmp_path), keep_last=2)
    for step in (1, 2, 3):
        jm.save(step, params, extra={"step": step})
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    assert mgr.latest_step() == 3
    model = _port_model()
    restored, extra = mgr.restore(model.state_dict())
    assert extra == {"step": 3}
    model.load_state_dict(restored)
    want = _port_model(seed=1)
    load_reference_params(want, jax.tree_util.tree_map(np.asarray, params))
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    # the port rotates the JAX package's steps like its own
    os.makedirs(tmp_path / ".tmp_step_000000009")
    mgr.save(4, model.state_dict())
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000000003",
                                            "step_000000004"]
    with open(tmp_path / "step_000000004" / "manifest.json") as f:
        assert json.load(f)["num_leaves"] == len(model.state_dict())


def test_restore_refuses_a_wrong_model(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _port_model().state_dict())
    small = DLRM(DLRMConfig(embedding=EmbeddingStageConfig(
        num_tables=TABLES, rows=ROWS // 2, dim=DIM, pooling=POOL),
        dense_features=4, bottom_mlp=(16, DIM), top_mlp=(8, 1)),
        device="cpu")
    with pytest.raises(CheckpointError, match="shape"):
        mgr.restore(small.state_dict())
    with pytest.raises(CheckpointError, match="leaves"):
        mgr.restore({"only": torch.zeros(1)})


# ---------------------------------------------------------------------------
# storage-level round trip: invisible -> commit bit-exact -> abort clean
# ---------------------------------------------------------------------------

def _pooled(tables, idx):
    """The port's dense path on explicit [T, R, D] tables."""
    rows = torch.from_numpy(tables[np.arange(TABLES)[None, :, None], idx])
    return _pool_rows_core(rows, None, "sum")


def _storage_model(kind):
    model = _port_model(kind)
    if kind == "tiered":
        model.ebc.storage.build(PSConfig(hot_rows=16, warm_slots=16,
                                         prefetch_depth=2))
    return model


@pytest.mark.parametrize("kind", ["device", "tiered"])
def test_update_invisible_then_commit_bit_exact(kind):
    pats = _pats()
    rng = np.random.default_rng(0)
    model = _storage_model(kind)
    st = model.ebc.storage
    tables = model.ebc.tables[:TABLES].numpy().copy()
    idx = _batch(pats, 8, seed=1)

    def lookup():
        with torch.no_grad():
            return model.ebc(idx if kind == "tiered"
                             else torch.from_numpy(idx))

    assert st.capabilities().updatable and st.version() == 0
    assert torch.equal(lookup(), _pooled(tables, idx))
    changed, want = _delta(rng, tables)
    st.begin_update(1)
    for t, (rows, vals) in changed.items():
        st.apply_update(t, rows, vals)
    assert torch.equal(lookup(), _pooled(tables, idx))      # invisible
    res = st.commit_update(1)
    assert res["updated"] and res["version"] == 1 and st.version() == 1
    assert torch.equal(lookup(), _pooled(want, idx))
    changed2, _ = _delta(rng, want)
    st.begin_update(2)
    for t, (rows, vals) in changed2.items():
        st.apply_update(t, rows, vals)
    assert st.abort_update(2) is True
    assert st.abort_update(2) is False
    assert st.version() == 1
    assert torch.equal(lookup(), _pooled(want, idx))
    st.close()


def test_update_txn_guards():
    st = _storage_model("tiered").ebc.storage
    with pytest.raises(ValueError, match="monotonic"):
        st.begin_update(0)
    with pytest.raises(RuntimeError, match="begin_update"):
        st.apply_update(0, np.array([0]), np.zeros((1, DIM), np.float32))
    with pytest.raises(RuntimeError, match="begin_update"):
        st.commit_update(1)
    st.begin_update(1)
    with pytest.raises(RuntimeError, match="already"):
        st.begin_update(2)
    with pytest.raises(ValueError, match="outside"):
        st.apply_update(TABLES, np.array([0]), np.zeros((1, DIM), np.float32))
    with pytest.raises(ValueError, match="outside"):
        st.apply_update(0, np.array([ROWS]), np.zeros((1, DIM), np.float32))
    with pytest.raises(ValueError, match="shape"):
        st.apply_update(0, np.array([0]), np.zeros((2, DIM), np.float32))
    with pytest.raises(ValueError, match="dtype"):
        st.apply_update(0, np.array([0]), np.zeros((1, DIM), np.float64))
    with pytest.raises(ValueError, match="does not match"):
        st.commit_update(7)
    assert st.version() == 0
    assert st.abort_update(1)
    st.close()


def test_update_last_write_wins():
    model = _storage_model("tiered")
    st = model.ebc.storage
    tables = model.ebc.tables[:TABLES].numpy().copy()
    rng = np.random.default_rng(1)
    first = rng.normal(size=(3, DIM)).astype(np.float32)
    last = rng.normal(size=(2, DIM)).astype(np.float32)
    st.begin_update(1)
    st.apply_update(2, np.array([4, 5, 6]), first)
    st.apply_update(2, np.array([5, 6]), last)
    st.apply_update(3, np.array([], np.int64),
                    np.zeros((0, DIM), np.float32))
    res = st.commit_update(1)
    assert res["updated"] and res["tables"] == 1
    want = tables.copy()
    want[2, [4, 5, 6]] = first
    want[2, [5, 6]] = last
    idx = _batch(_pats(), 8, seed=2)
    with torch.no_grad():
        assert torch.equal(model.ebc(idx), _pooled(want, idx))
    st.close()


# ---------------------------------------------------------------------------
# serving session: epoch guard — per-qid pinning, single-version batches,
# answers equal to the dense oracle and to the JAX session's
# ---------------------------------------------------------------------------

def _guard_models(kind, combine):
    ecfg = dict(num_tables=4, rows=64, dim=8, pooling=2, combine=combine)
    mlp = dict(dense_features=4, bottom_mlp=(16, 8), top_mlp=(8, 1))
    jmodel = JDLRM(JConfig(embedding=JStage(**ecfg, storage=kind,
                                            backend="xla"), **mlp))
    params = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = DLRM(DLRMConfig(embedding=EmbeddingStageConfig(
        **ecfg, storage=kind), **mlp), device="cpu")
    load_reference_params(model, np_params)
    oracle = DLRM(DLRMConfig(embedding=EmbeddingStageConfig(**ecfg), **mlp),
                  device="cpu")
    load_reference_params(oracle, np_params)
    if kind == "tiered":
        ps = dict(hot_rows=8, warm_slots=16, prefetch_depth=2)
        jmodel.ebc.storage.build(params, JPSConfig(**ps))
        model.ebc.storage.build(PSConfig(**ps))
    return jmodel, params, model, oracle


@pytest.mark.parametrize("kind,combine", [("device", "sum"),
                                          ("tiered", "sum"),
                                          ("tiered", "mean")])
def test_session_epoch_guard_bit_exact(tmp_path, kind, combine):
    rng = np.random.default_rng(5)
    jmodel, params, model, oracle = _guard_models(kind, combine)
    tables0 = oracle.ebc.tables[:4].numpy().copy()
    pub = ModelUpdateStream(str(tmp_path))
    pub.publish_full(tables0)                # v1: the base snapshot
    cfg = dict(max_batch=8, max_wait_s=0.0)
    sess = serving.ServingSession(
        model, batcher=serving.BatcherConfig(**cfg),
        controllers=serving.configure(updates=serving.UpdateConfig(
            stream=ModelUpdateStream(str(tmp_path)))))
    jsess = jserving.ServingSession(
        jmodel, params, batcher=jserving.BatcherConfig(**cfg),
        controllers=jserving.configure(updates=jserving.UpdateConfig(
            stream=JStream(str(tmp_path)))))
    batches, jscores = [], {}
    sess.server.on_batch = lambda b, s: batches.append(
        ([q.qid for q in b], s.copy()))
    jsess.server.on_batch = lambda b, s: jscores.update(
        {q.qid: float(x) for q, x in zip(b, s)})

    snapshots = {0: tables0.copy(), 1: tables0.copy()}
    version_tables = tables0.copy()
    traffic = []
    for step in range(10):
        dense = rng.normal(size=(8, 4)).astype(np.float32)
        idx = rng.integers(0, 64, size=(8, 4, 2)).astype(np.int32)
        traffic.extend((dense[i], idx[i]) for i in range(8))
        for s in (sess, jsess):
            s.submit_batch(dense, idx)
            while s.poll(force=True):
                pass
        if step in (3, 6):
            t = step % 4
            rows = rng.choice(64, size=5, replace=False)
            vals = rng.normal(size=(5, 8)).astype(np.float32)
            v = pub.publish_delta({t: (rows, vals)})
            version_tables[t, rows] = vals
            snapshots[v] = version_tables.copy()
    for s in (sess, jsess):
        s.drain()
    p = sess.percentiles()
    assert p["updates_applied"] == 2 and p["model_version"] == 3, p
    assert p["updates_delta"] == 2 and p["updates_full"] == 0, p
    assert p["updates_rolled_back"] == 0 and p["update_stall_s"] >= 0.0
    jp = jsess.percentiles()
    for k in ("model_version", "updates_applied", "updates_delta",
              "updates_full", "updates_rolled_back"):
        assert p[k] == jp[k], k

    checked = 0
    for qids, scores in batches:
        pins = {sess.version_of(q) for q in qids}
        assert len(pins) == 1, f"mixed-version batch: {pins}"
        assert pins == {jsess.version_of(q) for q in qids}
        dense = np.zeros((8, 4), np.float32)   # the engine pads to max
        idx = np.zeros((8, 4, 2), np.int32)
        for i, q in enumerate(qids):
            dense[i], idx[i] = traffic[q]
        with torch.no_grad():
            oracle.ebc.tables[:4] = torch.from_numpy(snapshots[pins.pop()])
        with torch.inference_mode():
            want = oracle(torch.from_numpy(dense), torch.from_numpy(idx))
        np.testing.assert_array_equal(scores, want.numpy()[:len(qids)])
        torch.testing.assert_close(
            torch.from_numpy(scores),
            torch.tensor([jscores[q] for q in qids]), **TOL)
        checked += len(qids)
    assert checked == len(traffic) == len(jscores)
    sess.close()
    jsess.close()
