"""The port's step functions (`repro_torch.launch.steps`) and the dry-run
CLI on the CPU.

- `make_lm_train_step` on a gloo (2, 2) mesh equals the same step without
  a mesh (reduced phi4-mini, `fsdp_only`; reduced deepseek-v2-lite,
  `tp_fsdp` with expert parallelism inside): the loss within rtol 1e-5,
  every updated parameter within 2.5 lr (an Adam step is lr·m̂/(√v̂+eps),
  about ±lr per element, so a gradient element near zero whose sign the
  sharded sums flip moves its parameter by up to 2 lr the other way).
- The port's step on a one-rank mesh equals JAX's `make_lm_train_step(...)
  .fn` on a one-device JAX mesh over converted parameters, to the same
  tolerances.
- `make_dlrm_serve_step` on a gloo (2, 2) mesh equals the plain forward
  bit for bit, and JAX's forward within tests/test_torch_dlrm.py's logits
  tolerance (rtol 1e-4, atol 1e-5).
- `remat=True` gradients equal `remat=False` bit for bit.
- The dry-run CLI writes a reduced cell's record with the JAX record's
  keys.

The LM serve steps on a mesh are in test_torch_launch_serve.py (each
file keeps near a minute).

Gloo ranks are spawned processes (a module-level function each, a
`file://` store under tmp_path); inputs and parameters go through .npz
files made from numpy seeds and the JAX package's init.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _spmd_ranks
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.embedding import EmbeddingStageConfig as JStage
from repro.launch.steps import make_lm_train_step as jax_make_lm_train_step
from repro.models import build_model as jax_build_model
from repro.models import pspec as jax_pspec
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JConfig
from repro.optim.optimizers import adamw_lowmem_init as jax_adamw_init
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (dlrm_state_dict_from_numpy,
                                 lm_state_dict_from_numpy)
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.models import DLRM, DLRMConfig, build_model
from repro_torch.optim import adamw_lowmem_init, adamw_lowmem_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, B1 = 1e-4, 0.9              # the train step's AdamW rate and beta1
LOSS_RTOL = 1e-5
MESH_GRAD_RTOL = 1e-4           # sharded against unsharded sums
JAX_GRAD_RTOL = 1e-3            # tests/test_torch_models.py's gradients
M_RTOL = 2.0 ** -7              # one bf16 step (8 bits of mantissa)
SETTLED_RTOL, SETTLED_ATOL = 1e-6, 1e-8
PARAM_ATOL = 2.5 * LR
LOGITS_TOL = {"rtol": 1e-4, "atol": 1e-5}   # tests/test_torch_dlrm.py's
SHAPE = _spmd_ranks.SHAPE


def _lm_cfgs(arch: str, overrides=None):
    import dataclasses
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                **(overrides or {})),
            dataclasses.replace(reduced(get_config(arch)),
                                **(overrides or {})))


def _lm_case(arch: str, tmp_path, overrides=None):
    """(port config, JAX params as numpy, tokens, labels, .npz path)."""
    jcfg, cfg = _lm_cfgs(arch, overrides)
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    toks, labels = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, SHAPE.global_batch, SHAPE.seq_len))
    sd = lm_state_dict_from_numpy(cfg, params)
    path = str(tmp_path / "lm.npz")
    np.savez(path, tokens=toks, labels=labels,
             **{k: v.numpy() for k, v in sd.items()})
    return cfg, params, toks, labels, path


def _plain_step(cfg, sd: dict, toks, labels) -> dict:
    """The train step without a mesh, keyed as `lm_step_rank` writes it:
    the loss, the gradients, Adam's new first moment and the updated
    parameters."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    opt = adamw_lowmem_init(params)
    loss = model.loss(torch.from_numpy(toks), torch.from_numpy(labels),
                      remat=True, vocab_chunk=512)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    adamw_lowmem_update(params, grads, opt, lr=LR)
    out = {"loss": float(loss.detach())}
    for n, p in params.items():
        out[n] = p.detach().numpy()
        out[f"grad.{n}"] = grads[n].numpy()
        out[f"m.{n}"] = opt["m"][n].float().numpy()
    return out


def _mesh_step(arch, shape, data, tmp_path, mode=None,
               overrides=None) -> dict:
    world = int(np.prod(shape))
    out = str(tmp_path / "step.npz")
    mp.spawn(_spmd_ranks.lm_step_rank, args=(world, shape, arch,
                                    str(tmp_path / "store"), data, out,
                                    mode, overrides),
             nprocs=world)
    return dict(np.load(out))


def _assert_step_close(got: dict, want: dict, grad_rtol: float):
    """The loss, then per parameter: the gradient within `grad_rtol` and
    an atol of `grad_rtol` x the leaf's max |g|; Adam's first moment
    (bf16) within one bf16 step of it; the updated parameter within f32
    rounding wherever the gradient's sign is settled (|g| above twice the
    gradient's tolerance; the first step moves an element by lr·g/(|g|+
    eps), about lr·sign(g)), and within PARAM_ATOL elsewhere."""
    np.testing.assert_allclose(float(got["loss"]), want["loss"],
                               rtol=LOSS_RTOL)
    names = [k[len("grad."):] for k in want if k.startswith("grad.")]
    assert names and {f"grad.{n}" for n in names} <= set(got)
    for n in names:
        g = want[f"grad.{n}"]
        g_atol = grad_rtol * float(np.abs(g).max())
        np.testing.assert_allclose(got[f"grad.{n}"], g, rtol=grad_rtol,
                                   atol=g_atol, err_msg=f"grad {n}")
        np.testing.assert_allclose(got[f"m.{n}"], want[f"m.{n}"],
                                   rtol=M_RTOL, atol=(1 - B1) * g_atol,
                                   err_msg=f"m {n}")
        settled = np.abs(g) > 2 * g_atol
        assert settled.any(), n
        np.testing.assert_allclose(got[n][settled], want[n][settled],
                                   rtol=SETTLED_RTOL, atol=SETTLED_ATOL,
                                   err_msg=f"param {n} (settled)")
        np.testing.assert_allclose(got[n], want[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"param {n}")


def _report(got: dict, want: dict):
    for kind in ("grad.", "m.", ""):
        keys = [k for k in want if k.startswith(kind) and k != "loss"
                and (kind or not k.startswith(("grad.", "m.")))]
        print(kind or "param", "max|d|", max(
            float(np.abs(got[k] - want[k]).max()) for k in keys))


@pytest.mark.parametrize("arch,mode", [("phi4-mini-3.8b", "fsdp_only"),
                                       ("deepseek-v2-lite-16b", "tp_fsdp")])
def test_lm_train_step_on_mesh_matches_unsharded(arch, mode, tmp_path):
    cfg, _, toks, labels, data = _lm_case(arch, tmp_path)
    sd = {k: torch.from_numpy(v) for k, v in np.load(data).items()
          if k not in ("tokens", "labels")}
    want = _plain_step(cfg, sd, toks, labels)
    got = _mesh_step(arch, (2, 2), data, tmp_path)
    assert str(got["mode"]) == mode
    print("LOSS", float(got["loss"]), want["loss"])
    _report(got, want)
    _assert_step_close(got, want, MESH_GRAD_RTOL)


@pytest.mark.parametrize("arch,overrides", [
    ("phi4-mini-3.8b", {"num_kv_heads": 1}),
    ("rwkv6-7b", {"rwkv_head_dim": 128}),
])
def test_lm_train_step_split_regions_match_unsharded(arch, overrides,
                                                     tmp_path):
    """`tp_fsdp` on the (2, 2) mesh with channels that do not divide
    `model` (one KV head; one RWKV head): the attention splits its
    queries along the sequence over `model`, the WKV scan splits its
    (sequence, head) pairs over it, and the step equals the one without
    a mesh to the tolerances above."""
    cfg, _, toks, labels, data = _lm_case(arch, tmp_path, overrides)
    sd = {k: torch.from_numpy(v) for k, v in np.load(data).items()
          if k not in ("tokens", "labels")}
    want = _plain_step(cfg, sd, toks, labels)
    got = _mesh_step(arch, (2, 2), data, tmp_path, "tp_fsdp", overrides)
    assert str(got["mode"]) == "tp_fsdp"
    _report(got, want)
    _assert_step_close(got, want, MESH_GRAD_RTOL)


def test_lm_train_step_matches_jax(tmp_path):
    """One-rank mesh against JAX's step on a one-device mesh, phi4-mini:
    JAX's gradient step (`with_optimizer=False`) and its AdamW step."""
    arch = "phi4-mini-3.8b"
    jcfg, cfg = _lm_cfgs(arch)
    _, params, toks, labels, data = _lm_case(arch, tmp_path)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jparams = jax.tree.map(jnp.asarray, params)
    try:
        with mesh:
            _, grads = jax.jit(jax_make_lm_train_step(
                jcfg, SHAPE, mesh, with_optimizer=False).fn)(jparams, batch)
            loss, new, opt = jax.jit(jax_make_lm_train_step(
                jcfg, SHAPE, mesh).fn)(jparams, jax_adamw_init(jparams),
                                       batch)
    finally:
        jax_pspec.set_parallel_mode("tp_fsdp")

    def flat(tree, prefix=""):
        tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
        return {prefix + k: v.numpy()
                for k, v in lm_state_dict_from_numpy(cfg, tree).items()}
    want = {"loss": float(loss), **flat(new), **flat(grads, "grad."),
            **flat(opt["m"], "m.")}
    got = _mesh_step(arch, (1, 1), data, tmp_path)
    print("LOSS", float(got["loss"]), float(loss))
    _report(got, want)
    _assert_step_close(got, want, JAX_GRAD_RTOL)


# ---------------------------------------------------------------------------
# DLRM serve step
# ---------------------------------------------------------------------------

DLRM_STAGE, DLRM_MLP, DLRM_BATCH = (_spmd_ranks.DLRM_STAGE,
                                    _spmd_ranks.DLRM_MLP,
                                    _spmd_ranks.DLRM_BATCH)


def test_dlrm_serve_step_on_mesh(tmp_path):
    jcfg = JConfig(embedding=JStage(**DLRM_STAGE, backend="xla"), **DLRM_MLP)
    cfg = DLRMConfig(embedding=EmbeddingStageConfig(**DLRM_STAGE), **DLRM_MLP)
    jmodel = JDLRM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    dense = rng.normal(size=(DLRM_BATCH, 5)).astype(np.float32)
    idx = rng.integers(0, DLRM_STAGE["rows"], size=(
        DLRM_BATCH, DLRM_STAGE["num_tables"], DLRM_STAGE["pooling"])).astype(
        np.int32)
    want_jax = np.asarray(jmodel.forward(params, jnp.asarray(dense),
                                         jnp.asarray(idx)))
    sd = dlrm_state_dict_from_numpy(jax.tree.map(np.asarray, params))
    model = DLRM(cfg, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        want = model(torch.from_numpy(dense), torch.from_numpy(idx)).numpy()
    data = str(tmp_path / "dlrm.npz")
    np.savez(data, dense=dense, indices=idx,
             **{k: v.numpy() for k, v in sd.items()})
    out = str(tmp_path / "logits.npy")
    mp.spawn(_spmd_ranks.dlrm_serve_rank,
             args=(str(tmp_path / "store"), data, out), nprocs=4)
    got = np.load(out)
    print("max|d| plain", float(np.abs(got - want).max()),
          "jax", float(np.abs(got - want_jax).max()))
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, want_jax, **LOGITS_TOL)


# ---------------------------------------------------------------------------
# remat and the dry-run CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-lite-16b"])
def test_remat_gradients_bit_equal(arch):
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu", seed=0)
    toks, labels = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 2, 16)))
    params = list(model.parameters())
    grads = {}
    for remat in (False, True):
        loss = model.loss(toks, labels, remat=remat)
        grads[remat] = torch.autograd.grad(loss, params)
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


# src/repro/launch/dryrun.py's record: its keys, and its memory keys
# (fits_16GiB_HBM is the TPU's; the port's record has fits_80GB_HBM)
JAX_RECORD_KEYS = {"cell", "status", "arch", "shape", "mesh", "num_chips",
                   "lower_s", "compile_s", "memory", "roofline",
                   "model_flops_global", "useful_flops_ratio"}
JAX_MEMORY_KEYS = {"argument_bytes", "output_bytes", "alias_bytes",
                   "temp_bytes", "per_device_total"}


def test_dryrun_cli_writes_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "phi4-mini-3.8b", "--shape", "train_4k", "--reduced", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "phi4-mini-3.8b__train_4k__single: ok" in proc.stdout
    rec = json.loads((tmp_path / "phi4-mini-3.8b__train_4k__single.json")
                     .read_text())
    assert JAX_RECORD_KEYS <= set(rec)
    assert JAX_MEMORY_KEYS | {"fits_80GB_HBM"} <= set(rec["memory"])
    assert rec["num_chips"] == 256 and rec["status"] == "ok"
    assert rec["roofline"]["per_device_flops"] > 0
    assert rec["memory"]["per_device_total"] > 0
