"""Training on the port against the TPU path.

* `DLRM.loss` and its gradients on weights carried across from
  `repro.models.dlrm.DLRM.init` against `jax.value_and_grad(model.loss)`:
  the loss rtol 1e-5; every gradient rtol 1e-4, atol 1e-6 (float32 MLP
  backward in another order); the table gradient of the same pooled
  gradient within the summation bound, 2·eps·Σ|w·g| per element.
* `embedding_bag_backward`, the plain backward of the CUDA kernel's
  autograd Function, against `torch.autograd.grad` through
  `ref.embedding_bag_ref`, within the same bound.
* `train_dlrm`'s step against the reference example's step for 5 steps
  (losses within 1e-5·max(1, |loss|)), and `TrainLoop`'s four cases of
  tests/test_substrate.py.

Everything runs on CPU tensors: the port's lookup takes the plain gather
and autograd differentiates it; on the card the Function's backward runs
(`chip_smoke.py`'s train phase holds it there).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core.embedding import EmbeddingStageConfig as JStage
from repro.data import DLRMQueryStream as JStream
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro_torch.convert import load_reference_params
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.examples import train_dlrm
from repro_torch.kernels.embedding_bag import (EmbeddingBagFunction,
                                               EmbeddingBagOpts,
                                               embedding_bag_backward, ref)
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.ps import PSConfig
from repro_torch.runtime import TrainLoop, TrainLoopConfig

TABLES, ROWS, DIM, POOL, F, BATCH = 3, 400, 16, 6, 5, 12
MLP = dict(dense_features=F, bottom_mlp=(32, DIM), top_mlp=(16, 8, 1))
GTOL = dict(rtol=1e-4, atol=1e-6)
EPS = ref.F32_EPS


def _configs(combine="sum", storage="device"):
    stage = dict(num_tables=TABLES, rows=ROWS, dim=DIM, pooling=POOL,
                 combine=combine)
    return (JConfig(embedding=JStage(**stage, backend="xla"), **MLP),
            DLRMConfig(embedding=EmbeddingStageConfig(**stage,
                                                      storage=storage),
                       **MLP))


def _pair(combine="sum", seed=0, storage="device"):
    jcfg, cfg = _configs(combine, storage)
    jmodel = JDLRM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = DLRM(cfg, device="cpu", seed=seed)
    load_reference_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, model


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(BATCH, F)).astype(np.float32)
    idx = rng.integers(0, ROWS, size=(BATCH, TABLES, POOL)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]              # duplicates inside every bag
    idx[1] = idx[0]                          # and across bags
    labels = (rng.random(BATCH) < 0.3).astype(np.float32)
    return dense, idx, labels


def _scatter_bound(grad_out, idx, weights, mode, shape):
    """2·eps·Σ|w·g| per element of the table gradient."""
    return 2 * EPS * embedding_bag_backward(
        grad_out.abs(), idx, None if weights is None else weights.abs(),
        mode, shape)


def _within(got, want, bound, what):
    err = (got - want).abs()
    assert bool((err <= bound).all()), (
        f"{what}: max excess {(err - bound).max().item():.3e}")


# -- DLRM.loss and its gradients --------------------------------------------------

@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_loss_and_gradients_match_jax(combine):
    jmodel, params, model = _pair(combine)
    dense, idx, labels = _batch()
    jargs = tuple(map(jnp.asarray, (dense, idx, labels)))
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(params, *jargs)

    tables = model.ebc.tables.requires_grad_(True)
    named = dict(model.named_parameters())
    loss = model.loss(*map(torch.from_numpy, (dense, idx, labels)))
    grads = torch.autograd.grad(loss, [*named.values(), tables])
    torch.testing.assert_close(loss, torch.tensor(float(jloss)), rtol=1e-5,
                               atol=0)
    for (name, _), g in zip(named.items(), grads):
        tower, leaf = name.split(".")
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[tower][leaf]),
                                   err_msg=name, **GTOL)
    jtab = np.asarray(jgrads["embedding"]["tables"])
    np.testing.assert_allclose(grads[-1].numpy(), jtab, **GTOL)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_table_gradient_of_one_pooled_gradient_matches_jax(combine):
    """The scatter alone: both packages' table gradient for the same pooled
    gradient (JAX's transpose of its gather), within the summation bound."""
    jmodel, params, model = _pair(combine, seed=2)
    _, idx, _ = _batch(seed=3)
    g = np.random.default_rng(4).normal(
        size=(BATCH, TABLES, DIM)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jmodel.ebc.apply({"tables": t},
                                                jnp.asarray(idx)),
                     params["embedding"]["tables"])
    want = torch.tensor(np.asarray(vjp(jnp.asarray(g))[0]))
    tables = model.ebc.tables.requires_grad_(True)
    got, = torch.autograd.grad(model.ebc(torch.from_numpy(idx)), tables,
                               grad_outputs=torch.from_numpy(g))
    bound = _scatter_bound(torch.from_numpy(g), torch.from_numpy(idx), None,
                           combine, tables.shape)
    _within(got, want, bound, combine)


# -- the kernel's plain backward -----------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_backward_matches_autograd_through_ref(mode, weighted):
    rng = np.random.default_rng(5)
    shape = (TABLES + 1, ROWS, DIM)                  # one pad table
    tables = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    _, idx, _ = _batch(seed=6)
    idx = torch.from_numpy(idx)
    w = (torch.from_numpy(rng.uniform(0.1, 2.0, size=idx.shape)
                          .astype(np.float32)) if weighted else None)
    g = torch.from_numpy(rng.normal(size=(BATCH, TABLES, DIM))
                         .astype(np.float32))
    leaf = tables.clone().requires_grad_(True)
    pooled = torch.stack([ref.embedding_bag_ref(
        leaf[t], idx[:, t], None if w is None else w[:, t], mode)
        for t in range(TABLES)], dim=1)
    want, = torch.autograd.grad(pooled, leaf, grad_outputs=g)
    got = embedding_bag_backward(g, idx, w, mode, shape)
    assert got.shape == shape and got.dtype == torch.float32
    _within(got, want, _scatter_bound(g, idx, w, mode, shape),
            f"{mode} weighted={weighted}")
    assert not got[TABLES].any()                     # pad table: no gradient


@pytest.mark.parametrize("bad", [-1, ROWS])
def test_backward_raises_on_out_of_range_before_writing(bad, monkeypatch):
    _, idx, _ = _batch()
    idx[3, 1, 2] = bad
    g = torch.ones(BATCH, TABLES, DIM)

    def no_scatter(*args, **kwargs):
        raise AssertionError("the backward scattered an out-of-range index")
    monkeypatch.setattr(torch.Tensor, "index_put_", no_scatter)
    with pytest.raises(IndexError, match=r"outside \[0, 400\)"):
        embedding_bag_backward(g, torch.from_numpy(idx), None, "sum",
                               (TABLES, ROWS, DIM))


def test_function_never_falls_back_on_the_cpu():
    _, idx, _ = _batch()
    tables = torch.zeros(TABLES, ROWS, DIM, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        EmbeddingBagFunction.apply(tables, torch.from_numpy(idx), None,
                                   EmbeddingBagOpts())


def test_device_lookup_gradient_equals_the_plain_backward():
    _, _, model = _pair(seed=7)
    _, idx, _ = _batch(seed=8)
    idx = torch.from_numpy(idx)
    g = torch.randn(BATCH, TABLES, DIM, generator=torch.Generator()
                    .manual_seed(0))
    tables = model.ebc.tables.requires_grad_(True)
    got, = torch.autograd.grad(model.ebc(idx), tables, grad_outputs=g)
    want = embedding_bag_backward(g, idx, None, "sum", tables.shape)
    _within(got, want, _scatter_bound(g, idx, None, "sum", tables.shape),
            "device lookup")


# -- trainable tables beside serving ---------------------------------------------

def test_trainable_tables_keep_their_key_load_strictly_and_take_updates():
    _, params, model = _pair(seed=9)
    tables = model.ebc.tables.requires_grad_(True)
    assert "ebc.tables" in model.state_dict()
    load_reference_params(model, jax.tree_util.tree_map(np.asarray, params))
    assert model.ebc.tables is tables and tables.requires_grad
    st = model.ebc.storage
    assert st.begin_update(1)
    vals = np.full((2, DIM), 3.0, np.float32)
    st.apply_update(1, np.array([5, 7]), vals)
    st.commit_update(1)
    assert model.ebc.tables is tables and tables.requires_grad
    np.testing.assert_array_equal(tables[1, [5, 7]].detach().numpy(), vals)


def test_host_backends_refuse_a_gradient():
    _, _, model = _pair(seed=10, storage="tiered")
    _, idx, _ = _batch(seed=11)
    model.ebc.storage.build(PSConfig(hot_rows=20, warm_slots=40,
                                     warm_backing="device"),
                            trace=idx)
    idx = torch.from_numpy(idx)
    model.ebc.tables.requires_grad_(True)
    with pytest.raises(RuntimeError, match="cannot differentiate"):
        model.ebc(idx)
    with torch.no_grad():
        assert model.ebc(idx).shape == (BATCH, TABLES, DIM)
    model.ebc.storage.close()


# -- the train step against the reference example's ---------------------------------

def _jax_train_step(model):
    """examples/train_dlrm.py's step, as the reference example writes it."""
    @jax.jit
    def train_step(state, dense, idx, labels):
        params = state["params"]
        loss, grads = jax.value_and_grad(model.loss)(params, dense, idx,
                                                     labels)
        dense_p, opt_dense = jopt.sgdm_update(
            {"bottom": params["bottom"], "top": params["top"]},
            {"bottom": grads["bottom"], "top": grads["top"]},
            state["opt_dense"], lr=0.01)
        emb_p, opt_emb = jopt.rowwise_adagrad_update(
            params["embedding"], grads["embedding"], state["opt_emb"],
            lr=0.05)
        new_params = {"bottom": dense_p["bottom"], "top": dense_p["top"],
                      "embedding": emb_p}
        return ({"params": new_params, "opt_dense": opt_dense,
                 "opt_emb": opt_emb}, loss)
    return train_step


def _port_stream():
    return train_dlrm.make_stream(_configs()[1], batch_size=BATCH)


def _stream_kw():
    return dict(num_tables=TABLES, rows=ROWS, pooling=POOL, batch_size=BATCH,
                dense_features=F, hotness="med_hot", seed=0)


def test_train_steps_match_jax_step_for_step():
    jmodel, params, model = _pair(seed=12)
    jstate = {"params": params,
              "opt_dense": jopt.sgdm_init({"bottom": params["bottom"],
                                           "top": params["top"]}),
              "opt_emb": jopt.rowwise_adagrad_init(params["embedding"])}
    jstep = _jax_train_step(jmodel)
    state = train_dlrm.train_state(model)
    step = train_dlrm.make_train_step(model)
    jstream = JStream(**_stream_kw())
    stream = _port_stream()
    for _ in range(5):
        jb, b = jstream.next_batch(), stream.next_batch()
        jstate, jloss = jstep(jstate, jnp.asarray(jb.dense),
                              jnp.asarray(jb.indices), jnp.asarray(jb.labels))
        state, loss = step(state, b)
        jloss = float(jloss)
        assert abs(float(loss) - jloss) <= 1e-5 * max(1.0, abs(jloss))
    np.testing.assert_allclose(
        state["opt_emb"]["acc"]["tables"].numpy(),
        np.asarray(jstate["opt_emb"]["acc"]["tables"]), rtol=1e-4, atol=1e-9)
    assert state["params"]["embedding"]["tables"] is model.ebc.tables


def test_train_dlrm_main_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    loop = train_dlrm.main(["--device", "cpu", "--steps", "3", "--ckpt", ckpt])
    assert [h.step for h in loop.history] == [0, 1, 2]
    assert all(np.isfinite(h.loss) for h in loop.history)
    again = train_dlrm.main(["--device", "cpu", "--steps", "4", "--ckpt",
                             ckpt])
    assert [h.step for h in again.history] == [3]
    out = capsys.readouterr().out
    assert "DLRM parameters: 99.0M" in out and "resumed from step 3" in out


# -- TrainLoop (tests/test_substrate.py's cases) --------------------------------------

class _ToyStream:
    def __init__(self):
        self.step = 0

    def next_batch(self):
        self.step += 1
        return float(self.step)

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, st):
        self.step = st["step"]


def _toy_step(state, batch):
    new = {"w": state["w"] + batch}
    return new, batch


def test_trainloop_checkpoints_and_restarts(tmp_path):
    cfg = TrainLoopConfig(total_steps=10, checkpoint_every=4, log_every=100)
    loop = TrainLoop(cfg, _toy_step, {"w": torch.zeros(())}, _ToyStream(),
                     str(tmp_path))
    loop.run()
    final_w = float(loop.state["w"])

    # completion checkpoint exists; a new incarnation restores it exactly
    loop2 = TrainLoop(cfg, _toy_step, {"w": torch.zeros(())}, _ToyStream(),
                      str(tmp_path))
    assert loop2.restore()
    assert loop2.step == 10
    loop2.run()  # nothing left to do
    assert float(loop2.state["w"]) == final_w

    # and a mid-training checkpoint restores to the right cursor
    restored, extra = loop2.ckpt.restore({"w": torch.zeros(())}, step=8)
    assert extra["step"] == 8
    assert restored["w"].shape == () and float(restored["w"]) == 36.0


def test_trainloop_retries_transient_failures(tmp_path):
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("interconnect reset")
        return state, 0.0
    cfg = TrainLoopConfig(total_steps=3, checkpoint_every=100,
                          retry_backoff_s=0.0)
    loop = TrainLoop(cfg, flaky, {"w": torch.zeros(())}, _ToyStream(),
                     str(tmp_path))
    loop.run()
    assert loop.step == 3 and calls["n"] == 4  # one retry


@pytest.mark.parametrize("where", ["forward", "adagrad"])
def test_trainloop_retry_of_the_train_step_applies_each_update_once(
        tmp_path, monkeypatch, where):
    """The port's step raises after its forward, or inside row-wise
    Adagrad where it squares the table gradient (the step's largest
    temporary, where it would run out of memory): either way before any
    write, so the retried run ends where an unbroken run ends, bit for
    bit."""
    real_square = torch.square

    def run(fail_on):
        _, _, model = _pair(seed=13)
        step = train_dlrm.make_train_step(model)
        real_loss, calls = model.loss, {"n": 0}

        def fault(out):
            calls["n"] += 1
            if calls["n"] == fail_on:
                raise RuntimeError(f"transient fault in the {where}")
            return out

        def loss(*args):
            return fault(real_loss(*args))

        def square(x):
            out = real_square(x)
            return fault(out) if x.dim() == 3 else out
        if where == "forward":
            model.loss = loss
        else:
            monkeypatch.setattr(torch, "square", square)
        cfg = TrainLoopConfig(total_steps=3, checkpoint_every=100,
                              retry_backoff_s=0.0)
        loop = TrainLoop(cfg, step, train_dlrm.train_state(model),
                         _port_stream(), str(tmp_path / f"f{fail_on}"))
        loop.run()
        return loop, calls["n"]

    clean, n_clean = run(fail_on=0)
    retried, n_retried = run(fail_on=2)
    assert (n_clean, n_retried) == (3, 4)
    assert [h.loss for h in retried.history] == [h.loss for h in
                                                 clean.history]
    for a, b in zip(jax.tree_util.tree_leaves(retried.state),
                    jax.tree_util.tree_leaves(clean.state)):
        assert torch.equal(a, b)


def test_trainloop_flags_stragglers(tmp_path):
    times = iter([0.01] * 5 + [0.2] + [0.01] * 4)

    def slow_step(state, batch):
        time.sleep(next(times))
        return state, 0.0
    cfg = TrainLoopConfig(total_steps=10, checkpoint_every=100,
                          straggler_factor=3.0)
    loop = TrainLoop(cfg, slow_step, {}, _ToyStream(), str(tmp_path))
    hist = loop.run()
    assert sum(h.straggler for h in hist) >= 1


def test_trainloop_preemption_saves(tmp_path):
    cfg = TrainLoopConfig(total_steps=100, checkpoint_every=1000)
    loop = TrainLoop(cfg, _toy_step, {"w": torch.zeros(())}, _ToyStream(),
                     str(tmp_path))

    def step_then_preempt(state, batch):
        if loop.step == 4:
            loop._preempted = True
        return _toy_step(state, batch)
    loop.step_fn = step_then_preempt
    loop.run()
    assert loop.ckpt.latest_step() == 5  # saved on the preemption boundary
