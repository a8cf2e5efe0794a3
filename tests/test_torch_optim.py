"""The port's optimizers against the TPU path's, over 3 steps on the same
numpy parameters and gradients.

Tolerances: row-wise Adagrad's accumulators rtol 1e-6 (a mean of D
squares, summed in another order); parameters and every other state
rtol 1e-5, atol 1e-7 (float32 updates, the reference's formulas in the
reference's order); bfloat16 state one bf16 ulp (2^-8) relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim

PTOL = dict(rtol=1e-5, atol=1e-7)


def _tree(seed, shapes=None):
    rng = np.random.default_rng(seed)
    shapes = shapes or {"mlp": {"w0": (6, 4), "b0": (4,)},
                        "emb": {"tables": (3, 10, 8)}}
    return {k: (_tree_of(rng, v) if isinstance(v, dict) else
                rng.normal(size=v).astype(np.float32))
            for k, v in shapes.items()}


def _tree_of(rng, shapes):
    return {k: rng.normal(size=v).astype(np.float32)
            for k, v in shapes.items()}


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  tree)


def _close(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.float().numpy(), got))
    flat_w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), want))
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, **tol)


def _run(init, update, jinit, jupdate, params_np, **hp):
    params = _to_torch(params_np)
    ids = [id(t) for t in jax.tree_util.tree_leaves(params)]
    state = init(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstate = jinit(jparams)
    for step in range(3):
        grads_np = _tree(100 + step, jax.tree_util.tree_map(
            np.shape, params_np))
        params, state = update(params, _to_torch(grads_np), state, **hp)
        jparams, jstate = jupdate(jparams, jax.tree_util.tree_map(
            jnp.asarray, grads_np), jstate, **hp)
    # updated in place: the returned leaves are the tensors given
    assert [id(t) for t in jax.tree_util.tree_leaves(params)] == ids
    return params, state, jparams, jstate


@pytest.mark.parametrize("hp", [{}, {"lr": 0.05, "beta": 0.5}])
def test_sgdm_matches_jax(hp):
    params, state, jparams, jstate = _run(
        optim.sgdm_init, optim.sgdm_update, jopt.sgdm_init, jopt.sgdm_update,
        _tree(0), **hp)
    _close(params, jparams, **PTOL)
    _close(state["mom"], jstate["mom"], **PTOL)


@pytest.mark.parametrize("hp", [{}, {"lr": 0.05}])
def test_rowwise_adagrad_matches_jax(hp):
    tables = {"tables": _tree(1)["emb"]["tables"]}
    params, state, jparams, jstate = _run(
        optim.rowwise_adagrad_init, optim.rowwise_adagrad_update,
        jopt.rowwise_adagrad_init, jopt.rowwise_adagrad_update, tables, **hp)
    assert state["acc"]["tables"].shape == (3, 10)
    _close(state["acc"], jstate["acc"], rtol=1e-6, atol=0)
    _close(params, jparams, **PTOL)


def test_rowwise_adagrad_bf16_tables_match_jax():
    tables = _tree(2)["emb"]["tables"]
    params = {"tables": torch.tensor(tables).to(torch.bfloat16)}
    jparams = {"tables": jnp.asarray(tables, jnp.bfloat16)}
    state = optim.rowwise_adagrad_init(params)
    jstate = jopt.rowwise_adagrad_init(jparams)
    for step in range(3):
        g = np.random.default_rng(10 + step).normal(
            size=tables.shape).astype(np.float32)
        params, state = optim.rowwise_adagrad_update(
            params, {"tables": torch.tensor(g)}, state, lr=0.05)
        jparams, jstate = jopt.rowwise_adagrad_update(
            jparams, {"tables": jnp.asarray(g)}, jstate, lr=0.05)
    assert params["tables"].dtype == torch.bfloat16
    _close(state["acc"], jstate["acc"], rtol=1e-6, atol=0)
    _close(params, jparams, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("hp", [{}, {"lr": 1e-2, "wd": 0.0}])
def test_adamw_matches_jax(hp):
    params, state, jparams, jstate = _run(
        optim.adamw_init, optim.adamw_update, jopt.adamw_init,
        jopt.adamw_update, _tree(3), **hp)
    _close(params, jparams, **PTOL)
    for k in ("m", "v", "master"):
        _close(state[k], jstate[k], **PTOL)
    assert int(state["count"]) == int(jstate["count"]) == 3


def test_adamw_lowmem_matches_jax():
    params, state, jparams, jstate = _run(
        optim.adamw_lowmem_init, optim.adamw_lowmem_update,
        jopt.adamw_lowmem_init, jopt.adamw_lowmem_update, _tree(4),
        lr=1e-2, wd=0.01)
    _close(params, jparams, **PTOL)
    for k in ("m", "v"):
        assert jax.tree_util.tree_leaves(state[k])[0].dtype == torch.bfloat16
        _close(state[k], jstate[k], rtol=2 ** -8, atol=0)
    assert int(state["count"]) == int(jstate["count"]) == 3


def test_compress_grads_and_error_feedback_match_jax():
    grads_np = _tree(5)
    comp, resid = optim.compress_grads(_to_torch(grads_np))
    jcomp, jresid = jopt.compress_grads(jax.tree_util.tree_map(
        jnp.asarray, grads_np))
    assert jax.tree_util.tree_leaves(comp)[0].dtype == torch.bfloat16
    _close(comp, jcomp, rtol=0, atol=0)
    _close(resid, jresid, rtol=0, atol=0)
    fed = optim.apply_error_feedback(comp, resid)
    jfed = jopt.apply_error_feedback(jcomp, jresid)
    _close(fed, jfed, rtol=0, atol=0)
    # compressed + residual restores the float32 gradient
    _close(fed, grads_np, rtol=0, atol=0)
    assert optim.apply_error_feedback(comp, None) is comp


def test_optimizer_state_checkpoints_as_a_nested_dict(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    params = _to_torch(_tree(6))
    state = {"sgd": optim.sgdm_init(params),
             "ada": optim.rowwise_adagrad_init(params["emb"])}
    params, state["sgd"] = optim.sgdm_update(params, _to_torch(_tree(7)),
                                             state["sgd"])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    flat, _ = mgr.restore(state, 1)
    assert set(flat) == {"sgd.mom.mlp.w0", "sgd.mom.mlp.b0",
                         "sgd.mom.emb.tables", "ada.acc.tables"}
    assert torch.equal(flat["sgd.mom.emb.tables"],
                       state["sgd"]["mom"]["emb"]["tables"])
