"""Rank functions for the port's SPMD tests (test_torch_distribution.py,
test_torch_launch.py): each runs in a spawned process of a gloo group
over a `file://` store. Kept apart from the test files so a spawned rank
imports torch and the port alone, not JAX and the JAX package."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.sharding import distribute_params, param_specs
from repro_torch.launch.steps import (distribute_inputs,
                                      make_dlrm_serve_step,
                                      make_lm_serve_step,
                                      make_lm_train_step)
from repro_torch.models import DLRM, DLRMConfig, build_model, pspec
from repro_torch.models.config import ShapeConfig

SHAPE = ShapeConfig("t", 16, 4, "train")
DLRM_STAGE = dict(num_tables=8, rows=1000, dim=16, pooling=4)
DLRM_MLP = dict(dense_features=5, bottom_mlp=(32, 16), top_mlp=(32, 16, 1))
DLRM_BATCH = 16


def gloo(rank: int, world: int, store: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)


def moe_cfg():
    import dataclasses
    return dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                               moe_capacity_factor=8.0)


def moe_ep_rank(rank: int, store: str, data: str, out: str):
    """The MoE FFN with experts over a 4-rank `model` mesh."""
    gloo(rank, 4, store)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.layers import Params
    from repro_torch.models.transformer import _moe_apply
    arrs = dict(np.load(data))
    tree = {k: torch.from_numpy(v) for k, v in arrs.items()
            if k != "x" and not k.startswith("shared.")}
    tree["shared"] = {k.split(".")[1]: torch.from_numpy(v)
                      for k, v in arrs.items() if k.startswith("shared.")}
    params = Params(tree)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    specs = {n: pspec.P("model") if n in ("wi", "wg", "wo") else pspec.P()
             for n, _ in params.named_parameters()}
    distribute_params(params, mesh, specs)
    with pspec.spmd(mesh), torch.no_grad():
        y = _moe_apply(params, moe_cfg(), torch.from_numpy(arrs["x"]),
                       mesh).full_tensor()
    if rank == 0:
        np.save(out, y.numpy())
    dist.destroy_process_group()


def vocab_loss_rank(rank: int, store: str, data: str, out: str):
    """reduced phi4-mini's loss with `mesh=` on a (2, 2) mesh."""
    gloo(rank, 4, store)
    arrs = dict(np.load(data))
    model = build_model(reduced(get_config("phi4-mini-3.8b")), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in arrs.items()
                           if k not in ("tokens", "labels")})
    mesh = make_debug_mesh((2, 2), device_type="cpu")
    distribute_params(model, mesh, param_specs(model, mesh))
    toks, labels = (distribute_inputs(torch.from_numpy(arrs[k]),
                                      pspec.P("data"), mesh)
                    for k in ("tokens", "labels"))
    with torch.no_grad():
        loss = model.loss(toks, labels, mesh=mesh).full_tensor()
    if rank == 0:
        np.save(out, loss.numpy())
    dist.destroy_process_group()


def lm_step_rank(rank: int, world: int, shape: tuple, arch: str,
                 store: str, data: str, out: str, mode=None,
                 overrides=None):
    """`make_lm_train_step` on a gloo mesh of `shape` (the parallel
    `mode` the step picks unless given; `overrides` replace fields of the
    reduced config): its gradient step (`with_optimizer=False`), then one
    AdamW step from the same parameters; rank 0 writes the loss, the
    gradients (`grad.<name>`), Adam's new first moment (`m.<name>`, in
    f32) and the updated parameters, all whole."""
    import dataclasses
    gloo(rank, world, store)
    arrs = dict(np.load(data))
    cfg = dataclasses.replace(reduced(get_config(arch)), **(overrides or {}))
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in arrs.items()
                           if k not in ("tokens", "labels")})
    mesh = make_debug_mesh(shape, device_type="cpu")
    g = make_lm_train_step(cfg, SHAPE, mesh, model=model,
                           with_optimizer=False, parallel_mode=mode)
    batch = distribute_inputs(
        {k: torch.from_numpy(arrs[k]) for k in ("tokens", "labels")},
        g.in_shardings[1], mesh)
    _, grads = g.fn(model, batch)
    b = make_lm_train_step(cfg, SHAPE, mesh, model=model,
                           parallel_mode=mode)
    loss, model, opt = b.fn(model, b.inputs[1], batch)
    full = {n: p.full_tensor().detach().numpy()
            for n, p in model.named_parameters()}
    full.update({f"grad.{n}": t.full_tensor().numpy()
                 for n, t in grads.items()})
    full.update({f"m.{n}": t.full_tensor().float().numpy()
                 for n, t in opt["m"].items()})
    loss = float(loss.full_tensor())      # a collective: every rank
    if rank == 0:
        np.savez(out, loss=loss, mode=b.meta["parallel_mode"], **full)
    pspec.set_parallel_mode("tp_fsdp")
    dist.destroy_process_group()


def dlrm_serve_rank(rank: int, store: str, data: str, out: str):
    """`make_dlrm_serve_step` on a (2, 2) mesh; rank 0 writes the logits."""
    gloo(rank, 4, store)
    arrs = dict(np.load(data))
    cfg = DLRMConfig(embedding=EmbeddingStageConfig(**DLRM_STAGE),
                     **DLRM_MLP)
    model = DLRM(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in arrs.items()
                           if k not in ("dense", "indices")})
    mesh = make_debug_mesh((2, 2), device_type="cpu")
    b = make_dlrm_serve_step(cfg, mesh, batch=DLRM_BATCH, model=model)
    batch = distribute_inputs(
        {k: torch.from_numpy(arrs[k]) for k in ("dense", "indices")},
        b.in_shardings[1], mesh)
    logits = b.fn(model, batch).full_tensor().numpy()
    if rank == 0:
        np.save(out, logits)
    dist.destroy_process_group()


def dlrm_serve_fused_rank(rank: int, store: str, data: str, out: str):
    """`dlrm_serve_rank` with the towers' path rule taking the CPU for
    CUDA (`tower_path`'s "fused_local" on DTensors); rank 0 writes the
    logits and each tower's `epilogue_layers`."""
    from repro_torch.models import layers
    rule = layers.tower_path
    layers.tower_path = lambda device, graph, dtensor: rule(
        "cuda", graph, dtensor)
    gloo(rank, 4, store)
    arrs = dict(np.load(data))
    cfg = DLRMConfig(embedding=EmbeddingStageConfig(**DLRM_STAGE),
                     **DLRM_MLP)
    model = DLRM(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in arrs.items()
                           if k not in ("dense", "indices")})
    mesh = make_debug_mesh((2, 2), device_type="cpu")
    b = make_dlrm_serve_step(cfg, mesh, batch=DLRM_BATCH, model=model)
    batch = distribute_inputs(
        {k: torch.from_numpy(arrs[k]) for k in ("dense", "indices")},
        b.in_shardings[1], mesh)
    logits = b.fn(model, batch).full_tensor().numpy()
    if rank == 0:
        np.savez(out, logits=logits, counts=np.array(
            [model.bottom.epilogue_layers, model.top.epilogue_layers]))
    dist.destroy_process_group()


def lm_serve_rank(rank: int, arch: str, store: str, data: str, out: str):
    """Prefill a [4, 8] prompt into a 16-long cache, then one decode step,
    through `make_lm_serve_step` on a (2, 2) mesh; rank 0 writes both
    logits."""
    gloo(rank, 4, store)
    arrs = dict(np.load(data))
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in arrs.items()
                           if k not in ("tokens", "token")})
    mesh = make_debug_mesh((2, 2), device_type="cpu")
    prefill = make_lm_serve_step(cfg, ShapeConfig("t", 16, 4, "prefill"),
                                 mesh, model=model)
    cache = prefill.inputs[1]["cache"]
    tokens = distribute_inputs(torch.from_numpy(arrs["tokens"]),
                               pspec.P("data"), mesh)
    first, cache = prefill.fn(model, {"tokens": tokens, "cache": cache})
    decode = make_lm_serve_step(cfg, ShapeConfig("t", 16, 4, "decode"),
                                mesh, model=model)
    token = distribute_inputs(torch.from_numpy(arrs["token"]),
                              pspec.P("data"), mesh)
    second, _ = decode.fn(model, {"token": token, "cache": cache,
                                  "cache_pos": arrs["tokens"].shape[1]})
    first, second = first.full_tensor(), second.full_tensor()
    if rank == 0:
        np.savez(out, prefill=first.numpy(), decode=second.numpy())
    dist.destroy_process_group()


def seq_decode_rank(rank: int, store: str, data: str, out: str):
    """One decode query against a cache sharded along the sequence over
    `model` (one KV head, so heads cannot take the axis): the per-rank
    softmax combined across the two ranks."""
    gloo(rank, 2, store)
    from repro_torch.models.attention import chunked_attention
    arrs = dict(np.load(data))
    mesh = make_debug_mesh((1, 2), device_type="cpu")
    q = distribute_inputs(torch.from_numpy(arrs["q"]), pspec.P(), mesh)
    k, v = (distribute_inputs(torch.from_numpy(arrs[n]),
                              pspec.P(None, "model"), mesh)
            for n in ("k", "v"))
    with pspec.spmd(mesh), torch.no_grad():
        got = chunked_attention(q, k, v, causal=True,
                                q_offset=torch.tensor(11), kv_len=12)
        got = got.full_tensor()
    if rank == 0:
        np.save(out, got.numpy())
    dist.destroy_process_group()
