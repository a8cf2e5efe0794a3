"""Step functions and their inputs for every (arch x shape) cell, and the
DLRM's serve and train steps, on DTensor.

`make_step(cfg, shape, mesh)` returns a `StepBundle`: `fn(*inputs)` runs
one step on the mesh. The model's parameters are swapped for DTensor
parameters with `param_specs`' placements (`distribute_params`); the
inputs are DTensors with `input_specs`' placements (`lm_inputs` builds
them on the meta device, shapes only, as JAX's `ShapeDtypeStruct`s;
`distribute_inputs` places real tensors). Steps run inside
`pspec.use_mesh(mesh)`, forward, backward and update.

`donate_argnums` is kept from the JAX bundle and means nothing to torch:
the port's train steps update the parameters and the optimizer state in
place (and a serve step its cache), which is what donation buys in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import dp_axes
from repro_torch.launch.sharding import (batch_spec, cache_specs,
                                         distribute_params, param_specs)
from repro_torch.models import build_model, pspec
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.pspec import P, mesh_axes, to_placements
from repro_torch.optim.optimizers import (adamw_lowmem_init,
                                          adamw_lowmem_update)

META = torch.device("meta")


def pick_parallel_mode(cfg: ModelConfig, shape: ShapeConfig, mesh) -> str:
    """fsdp_only when the whole-mesh batch divides AND the model is too
    narrow to feed 16-way TP. MoE archs keep TP (EP needs the model
    axis)."""
    chips = math.prod(mesh_axes(mesh).values())
    tokens_ok = shape.kind == "train" and shape.global_batch % chips == 0
    narrow = cfg.d_model <= 3072 and not cfg.moe_num_experts
    return "fsdp_only" if (tokens_ok and narrow) else "tp_fsdp"


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Any                  # callable(*inputs)
    inputs: Any              # (model, [optimizer state,] batch)
    in_shardings: Any        # the specs of `inputs`, P trees
    out_shardings: Any
    donate_argnums: tuple[int, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)


def distribute_inputs(tree: Any, specs: Any, mesh) -> Any:
    """Tensors of `tree` as DTensors with the same-keyed spec's placements
    (dicts, lists and NamedTuples; a DTensor is redistributed). On a mesh
    of one device a tensor is wrapped without a copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute_inputs(v, specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(None if t is None else
                            distribute_inputs(t, s, mesh)
                            for t, s in zip(tree, specs)))
    if isinstance(tree, list):
        return [distribute_inputs(t, s, mesh) for t, s in zip(tree, specs)]
    if not torch.is_tensor(tree):
        return tree
    placements = to_placements(specs, mesh, tree.ndim)
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, placements)
    if math.prod(mesh.shape) == 1:
        return DTensor.from_local(tree, mesh, placements, run_check=False)
    return distribute_tensor(tree, mesh, placements)


# ---------------------------------------------------------------------------
# LM steps
# ---------------------------------------------------------------------------

def lm_inputs(cfg: ModelConfig, shape: ShapeConfig, model=None,
              device=META) -> dict:
    """The step's batch as plain tensors on `device` (meta: shapes only;
    zeros elsewhere). `model` makes the cache (its own device)."""
    b, s = shape.global_batch, shape.seq_len

    def z(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)
    out: dict[str, Any] = {}
    if cfg.is_encoder_decoder:
        if shape.kind in ("train", "prefill"):
            out["frames"] = z((b, s, cfg.d_model), torch.float32)
            out["tokens"] = z((b, cfg.decoder_text_len), torch.long)
            if shape.kind == "train":
                out["labels"] = z((b, cfg.decoder_text_len), torch.long)
        else:   # decode: decoder step against self cache + encoder output
            out["token"] = z((b, 1), torch.long)
            out["enc_out"] = z((b, cfg.encoder_seq_len, cfg.d_model),
                               cfg.torch_dtype)
            out["cache"] = model.init_cache(b, s)
            out["cache_pos"] = 0
        return out
    if shape.kind == "train":
        out["tokens"] = z((b, s), torch.long)
        out["labels"] = z((b, s), torch.long)
    elif shape.kind == "prefill":
        out["tokens"] = z((b, s), torch.long)
        out["cache"] = model.init_cache(b, s)
    else:   # decode
        out["token"] = z((b, 1), torch.long)
        out["cache"] = model.init_cache(b, s)
        out["cache_pos"] = 0
    if cfg.vision_prefix_tokens and shape.kind in ("train", "prefill"):
        out["vision_embeds"] = z((b, cfg.vision_prefix_tokens, cfg.d_model),
                                 torch.float32)
    return out


def input_specs(inputs: dict, mesh) -> dict:
    """Specs of `lm_inputs`' tensors: batch over dp where it divides (else
    replicated), the cache by `cache_specs`; `cache_pos` is a host int."""
    dp = dp_axes(mesh)
    dp_size = math.prod(mesh_axes(mesh)[a] for a in dp) if dp else 1
    specs: dict[str, Any] = {}
    for k, v in inputs.items():
        if k == "cache":
            specs[k] = cache_specs(v, mesh)
        elif k == "cache_pos":
            specs[k] = None
        else:
            specs[k] = (batch_spec(mesh) if v.shape[0] % dp_size == 0
                        else P())
    return specs


def _params(model) -> dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def make_lm_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       model=None, device=META, with_optimizer: bool = True,
                       parallel_mode: str | None = None,
                       lr: float = 1e-4) -> StepBundle:
    """One AdamW (bf16 moments) step of the LM on `mesh`: the loss with
    `remat=True` and `vocab_chunk=512`, as the JAX train step. `model`
    (built on `device` when None) has its parameters distributed in
    place."""
    mode = parallel_mode or pick_parallel_mode(cfg, shape, mesh)
    pspec.set_parallel_mode(mode)
    model = model if model is not None else build_model(cfg, device=device)
    pspecs = param_specs(model, mesh)
    distribute_params(model, mesh, pspecs)
    raw = lm_inputs(cfg, shape, model, device=model.device)
    ispecs = input_specs(raw, mesh)
    inputs = distribute_inputs(raw, ispecs, mesh)

    def loss_fn(batch):
        if cfg.is_encoder_decoder:
            return model.loss(batch["frames"], batch["tokens"],
                              batch["labels"])
        return model.loss(batch["tokens"], batch["labels"],
                          vision_embeds=batch.get("vision_embeds"),
                          mesh=mesh, remat=True, vocab_chunk=512)

    def grads_of(loss, params):
        gs = torch.autograd.grad(loss, list(params.values()))
        # a gradient comes back in its parameter's placements (FSDP's
        # reduce-scatter); redistribute where DTensor chose otherwise
        return {n: (g if tuple(g.placements) == tuple(p.placements)
                    else g.redistribute(p.device_mesh, p.placements))
                for (n, p), g in zip(params.items(), gs)}

    if with_optimizer:
        opt = adamw_lowmem_init(_params(model))

        def step(model_, opt_state, batch):
            pspec.set_parallel_mode(mode)
            with pspec.use_mesh(mesh):
                params = _params(model_)
                loss = loss_fn(batch)
                grads = grads_of(loss, params)
                _local_update(params, grads, opt_state, lr)
            return loss.detach(), model_, opt_state

        fn_inputs = (model, opt, inputs)
        in_sh = (pspecs, param_specs_like(opt, pspecs), ispecs)
        out_sh = (P(), pspecs, in_sh[1])
        donate = (0, 1)
    else:
        def step(model_, batch):
            pspec.set_parallel_mode(mode)
            with pspec.use_mesh(mesh):
                loss = loss_fn(batch)
                grads = grads_of(loss, _params(model_))
            return loss.detach(), grads

        fn_inputs = (model, inputs)
        in_sh = (pspecs, ispecs)
        out_sh = (P(), pspecs)
        donate = ()
    return StepBundle(name=f"{cfg.name}:{shape.name}:train", fn=step,
                      inputs=fn_inputs, in_shardings=in_sh,
                      out_shardings=out_sh, donate_argnums=donate,
                      meta={"kind": "train", "parallel_mode": mode})


def _local_update(params: dict, grads: dict, opt_state: dict, lr: float):
    """AdamW on each rank's own shards. The update is elementwise, and
    every gradient and moment has its parameter's placements, so it is
    the same update on the local tensors (written in place into the
    DTensors' storage), without DTensor's dispatch of each of its ops."""
    def local(tree):
        return {n: t.to_local() if pspec.is_dtensor(t) else t
                for n, t in tree.items()}
    with torch.no_grad():
        adamw_lowmem_update(local(params), local(grads),
                            {"m": local(opt_state["m"]),
                             "v": local(opt_state["v"]),
                             "count": opt_state["count"]}, lr=lr)


def make_lm_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       model=None, device=META) -> StepBundle:
    """Prefill (last-token logits and the filled cache) or one decode
    step, encoder-decoder too; the cache is written in place."""
    pspec.set_parallel_mode("tp_fsdp")
    model = model if model is not None else build_model(cfg, device=device)
    pspecs = param_specs(model, mesh)
    distribute_params(model, mesh, pspecs)
    raw = lm_inputs(cfg, shape, model, device=model.device)
    ispecs = input_specs(raw, mesh)
    b_out = P(pspec.batch_axes(mesh, shape.global_batch), None, None)
    kind = shape.kind
    name = f"{cfg.name}:{shape.name}:{kind}"

    if kind == "prefill" and cfg.is_encoder_decoder:
        keys = ("frames", "tokens")
        inputs = distribute_inputs({k: raw[k] for k in keys},
                                   {k: ispecs[k] for k in keys}, mesh)

        @torch.no_grad()
        def step(model_, batch):
            with pspec.use_mesh(mesh):
                enc = model_.encode(batch["frames"])
                logits, _ = model_.decode(batch["tokens"], enc)
            return logits[:, -1:]
        return StepBundle(name=name, fn=step, inputs=(model, inputs),
                          in_shardings=(pspecs, {k: ispecs[k]
                                                 for k in keys}),
                          out_shardings=b_out, meta={"kind": kind})

    inputs = distribute_inputs(raw, ispecs, mesh)
    if kind == "prefill":
        def step(model_, batch):
            with pspec.use_mesh(mesh):
                return model_.prefill(
                    batch["tokens"], batch["cache"],
                    vision_embeds=batch.get("vision_embeds"), mesh=mesh)
    elif cfg.is_encoder_decoder:
        @torch.no_grad()
        def step(model_, batch):
            with pspec.use_mesh(mesh):
                return model_.decode(batch["token"], batch["enc_out"],
                                     cache=batch["cache"],
                                     cache_pos=batch["cache_pos"])
    else:
        def step(model_, batch):
            with pspec.use_mesh(mesh):
                return model_.decode_step(batch["token"], batch["cache"],
                                          batch["cache_pos"], mesh=mesh)
    return StepBundle(name=name, fn=step, inputs=(model, inputs),
                      in_shardings=(pspecs, ispecs),
                      out_shardings=(b_out, ispecs["cache"]),
                      donate_argnums=(1,), meta={"kind": kind})


def param_specs_like(opt_state: dict, pspecs: dict) -> dict:
    """Optimizer state mirrors parameter sharding (m/v/master per param)."""
    out = {"count": P()}
    for k in ("m", "v", "master", "mom", "acc"):
        if k in opt_state:
            if k == "acc":   # row-wise adagrad: param spec minus last dim
                out[k] = {n: P(*s[:-1]) for n, s in pspecs.items()}
            else:
                out[k] = {n: pspecs[n] for n in opt_state[k]}
    if "count" not in opt_state:
        out.pop("count")
    return out


# ---------------------------------------------------------------------------
# DLRM steps
# ---------------------------------------------------------------------------

def _dlrm_named(model) -> dict[str, torch.Tensor]:
    """The DLRM's parameters and its tables buffer (`ebc.tables`, the JAX
    tree's `embedding.tables`)."""
    named = dict(model.named_parameters())
    named["ebc.tables"] = model.ebc.tables
    return named


def _dlrm_setup(dlrm_cfg, mesh, batch: int, model, device, *, train: bool):
    from repro_torch.models.dlrm import DLRM
    if dlrm_cfg.embedding.ragged or dlrm_cfg.interaction == "dcn":
        raise ValueError("the DLRM steps shard stacked tables table-wise "
                         "and the dot or cat interaction: not tables of "
                         "different sizes (RaggedStageConfig), nor the dcn "
                         "cross network")
    model = model if model is not None else DLRM(dlrm_cfg, device=device)
    pspecs = param_specs(_dlrm_named(model), mesh)
    distribute_params(model, mesh, pspecs)
    e = dlrm_cfg.embedding
    dev = model.ebc.tables.device
    raw = {"dense": torch.zeros((batch, dlrm_cfg.dense_features),
                                dtype=torch.float32, device=dev),
           "indices": torch.zeros((batch, e.num_tables, e.pooling),
                                  dtype=torch.int32, device=dev)}
    ispecs = {"dense": P(dp_axes(mesh), None),
              "indices": P(dp_axes(mesh), None, None)}
    if train:
        raw["labels"] = torch.zeros((batch,), dtype=torch.float32,
                                    device=dev)
        ispecs["labels"] = P(dp_axes(mesh))
    return model, pspecs, distribute_inputs(raw, ispecs, mesh), ispecs


def make_dlrm_serve_step(dlrm_cfg, mesh, batch: int = 2048, *, model=None,
                         device=META) -> StepBundle:
    """The DLRM forward on `mesh`: logits [B] batch-sharded. `model`
    (built on `device` when None) has its parameters and tables
    distributed in place."""
    model, pspecs, inputs, ispecs = _dlrm_setup(
        dlrm_cfg, mesh, batch, model, device, train=False)

    @torch.no_grad()
    def step(model_, batch_in):
        with pspec.use_mesh(mesh):
            return model_(batch_in["dense"], batch_in["indices"])

    return StepBundle(name="dlrm-production:serve", fn=step,
                      inputs=(model, inputs), in_shardings=(pspecs, ispecs),
                      out_shardings=P(dp_axes(mesh)), meta={"kind": "serve"})


def make_dlrm_train_step(dlrm_cfg, mesh, batch: int = 2048, *, model=None,
                         device=META, lr: float = 0.01) -> StepBundle:
    """One plain SGD step (p - lr·g) of the DLRM on `mesh`, tables
    included; the tables' gradient comes from the bag kernel's backward
    on the card."""
    model, pspecs, inputs, ispecs = _dlrm_setup(
        dlrm_cfg, mesh, batch, model, device, train=True)
    model.ebc.tables.requires_grad_(True)

    def step(model_, batch_in):
        with pspec.use_mesh(mesh):
            named = _dlrm_named(model_)
            loss = model_.loss(batch_in["dense"], batch_in["indices"],
                               batch_in["labels"])
            grads = torch.autograd.grad(loss, list(named.values()))
            with torch.no_grad():
                for p, g in zip(named.values(), grads):
                    if tuple(g.placements) != tuple(p.placements):
                        g = g.redistribute(p.device_mesh, p.placements)
                    p.sub_(lr * g)
        return loss.detach(), model_

    return StepBundle(name="dlrm-production:train", fn=step,
                      inputs=(model, inputs), in_shardings=(pspecs, ispecs),
                      out_shardings=(P(), pspecs), donate_argnums=(0,),
                      meta={"kind": "train"})


def make_step(cfg, shape: ShapeConfig, mesh, **kw) -> StepBundle:
    if shape.kind == "train":
        return make_lm_train_step(cfg, shape, mesh, **kw)
    return make_lm_serve_step(cfg, shape, mesh, **kw)
