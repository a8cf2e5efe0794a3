"""Name-rule-based parameter and cache sharding.

Strategy, as in the JAX package's `launch/sharding.py`: Megatron-style TP
over `model` for attention heads, FFN hidden, expert and vocab dims,
combined with FSDP-style sharding of the remaining large dim over the
data-parallel axes (`pod`, `data`), so parameters and optimizer state fit
at 398B scale. DTensor inserts the FSDP all-gathers at use sites.

Rules key on the port's dotted parameter names (`layers.{i}.mixer.wq`,
`embed`, `ebc.tables`). The port's layers are unstacked, so no spec
carries the JAX package's leading `None` for a stacked group dim. Every
rule checks divisibility and degrades to replication on mismatch (e.g.
whisper's odd 51865 vocab).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.launch.mesh import dp_axes
from repro_torch.models import pspec
from repro_torch.models.pspec import P, mesh_axes, to_placements


def _div(n: int, mesh, axes) -> bool:
    if not axes:
        return False
    shape = mesh_axes(mesh)
    size = math.prod(shape[a] for a in axes)
    return n % size == 0 and n >= size


def _axis(mesh, n: int, *prefs):
    """First preference (tuple of axis names) that divides n; else None."""
    axes = mesh_axes(mesh)
    for p in prefs:
        p = tuple(a for a in p if a in axes)
        if p and _div(n, mesh, p):
            return p if len(p) > 1 else p[0]
    return None


_COL = ("wq", "wk", "wv", "w_r", "w_k", "w_v", "w_g", "in_x", "in_z",
        "dt_proj", "wi", "wg", "w_lora_a", "cm_k", "cm_r")
_ROW = ("wo", "w_o", "out_proj", "x_proj", "w_lora_b", "cm_v")


def _rule_for(name: str, names: list[str], d, mesh, dp,
              untied: bool = False) -> P:
    def col():   # [in, out*]: TP on cols, FSDP on rows
        return P(_axis(mesh, d[0], dp), _axis(mesh, d[1], ("model",)))

    def row():   # [in*, out]: TP on rows, FSDP on cols
        return P(_axis(mesh, d[0], ("model",)), _axis(mesh, d[1], dp))

    if name in ("embed", "dec_embed"):   # [V, d]
        if untied and name == "embed":
            # untied: only the token gather reads this table; sharding d
            # keeps the gather local. FSDP over dp on V.
            return P(_axis(mesh, d[0], dp), _axis(mesh, d[1], ("model",)))
        return P(_axis(mesh, d[0], ("model",)), _axis(mesh, d[1], dp))
    if name == "lm_head":                # [d, V]
        return P(_axis(mesh, d[0], dp), _axis(mesh, d[1], ("model",)))
    if name in ("enc_pos", "dec_pos"):
        return P(None, _axis(mesh, d[1], ("model",)))
    if name in _COL or name in ("k_up", "v_up"):
        return col()
    if name in _ROW:
        return row()
    if name in ("w_dkv", "w_kr", "router"):
        return P(_axis(mesh, d[0], dp), None)
    if name == "conv_w":                 # [cd, di]
        return P(None, _axis(mesh, d[1], ("model",)))
    if name in ("conv_b", "dt_bias", "D", "ln_x"):
        return P(_axis(mesh, d[0], ("model",)))
    if name in ("A_log", "u"):           # [di, st] / [H, dh]
        return P(_axis(mesh, d[0], ("model",)), None)
    if name == "tables":                 # DLRM [T, R, D]
        # whole tables spread over ALL devices, then table-wise over TP
        # only, then row-wise
        t_ax = _axis(mesh, d[0], ("model", "data"), ("model",))
        if t_ax:
            return P(t_ax, None, None)
        return P(None, _axis(mesh, d[1], ("model",)), None)
    if len(d) >= 2 and names and "moe" not in names:
        # DLRM towers and other 2-D weights: FSDP rows only
        return P(_axis(mesh, d[0], dp))
    return P()   # norms, scalars, biases: replicated


def _spec_one(name: str, shape: tuple, mesh, dp, untied: bool) -> P:
    names = name.split(".")
    leaf = names[-1]
    if leaf in ("wi", "wg", "wo") and len(shape) == 3:
        # MoE experts [E, d, f]: experts over model, d over FSDP axes
        return P(_axis(mesh, shape[0], ("model",)),
                 _axis(mesh, shape[1], dp), None)
    return _rule_for(leaf, names, shape, mesh, dp, untied=untied)


def _fsdp_spec(name: str, shape: tuple, mesh) -> P:
    all_ax = pspec.all_axes(mesh)
    spec: list = [None] * len(shape)
    if name.split(".")[-1] in ("embed", "dec_embed", "lm_head") \
            and len(shape) == 2:
        # keep the gather/unembed dim whole: shard d (embed) / V (lm_head)
        spec[1] = _axis(mesh, shape[1], all_ax)
    else:
        # the largest divisible dim across ALL axes (ZeRO-3)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            ax = _axis(mesh, shape[i], all_ax)
            if ax is not None:
                spec[i] = ax
                break
    return P(*spec)


def _named_shapes(module_or_named_shapes) -> dict[str, tuple]:
    if isinstance(module_or_named_shapes, torch.nn.Module):
        items = module_or_named_shapes.named_parameters()
    else:
        items = module_or_named_shapes.items()
    return {n: tuple(getattr(v, "shape", v)) for n, v in items}


def param_specs(module_or_named_shapes, mesh) -> dict[str, P]:
    """{parameter name: P} for a module's parameters, or for a
    {name: tensor or shape} dict, under the current parallel mode."""
    shapes = _named_shapes(module_or_named_shapes)
    if pspec.parallel_mode() == "fsdp_only":
        return {n: _fsdp_spec(n, s, mesh) for n, s in shapes.items()}
    dp = dp_axes(mesh)
    untied = "lm_head" in shapes
    return {n: _spec_one(n, s, mesh, dp, untied) for n, s in shapes.items()}


def _cache_spec(field: str, shape: tuple, mesh) -> P:
    dp = dp_axes(mesh)
    spec: list = [None] * len(shape)
    spec[0] = _axis(mesh, shape[0], dp)
    if len(shape) >= 3 and field in ("k", "v"):        # [B, S, KV, hd]
        return pspec.kv_cache_spec(mesh, shape)        # THE rule
    if field in ("ckv", "krope"):                      # MLA [B, S, dim]
        return pspec.mla_cache_spec(mesh, shape)
    if field in ("h", "wkv", "shift_t", "shift_c"):    # channels at dim 1
        spec[1] = _axis(mesh, shape[1], ("model",))
    elif field == "conv":                              # [B, cd-1, di]
        spec[2] = _axis(mesh, shape[2], ("model",))
    return P(*spec)


def cache_specs(cache: Any, mesh) -> Any:
    """The cache's structure with a P in place of each tensor: a list (one
    layer's KVCache / MLACache / MambaState / RWKVState each) or a
    WhisperCache (its `self_kv` list; `cross_kv` is not carried)."""
    def one(layer):
        return type(layer)(*(None if t is None else
                             _cache_spec(f, tuple(t.shape), mesh)
                             for f, t in zip(layer._fields, layer)))
    if hasattr(cache, "self_kv"):
        return type(cache)(self_kv=[one(c) for c in cache.self_kv],
                           cross_kv=None)
    return [one(c) for c in cache]


def batch_spec(mesh) -> P:
    return P(dp_axes(mesh))


def distribute_params(module: torch.nn.Module, mesh,
                      specs: dict[str, P]) -> torch.nn.Module:
    """Swap each tensor of `module` named in `specs` (parameters, and
    buffers such as the DLRM's `ebc.tables`) for a DTensor with its spec's
    placements, in place; returns the module. On a mesh of one device each
    tensor is wrapped as it is (`DTensor.from_local`, no copy: the 64 GB
    of DLRM tables are not duplicated); otherwise `distribute_tensor`
    scatters it from rank 0's copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    one_device = math.prod(mesh.shape) == 1
    for name, spec in specs.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        is_param = leaf in owner._parameters
        tensor = owner._parameters[leaf] if is_param else owner._buffers[leaf]
        if isinstance(tensor, DTensor):
            continue
        placements = to_placements(spec, mesh, tensor.ndim)
        if one_device:
            dt = DTensor.from_local(tensor.detach(), mesh, placements,
                                    run_check=False)
        else:
            dt = distribute_tensor(tensor.detach(), mesh, placements)
        if is_param:
            owner._parameters[leaf] = torch.nn.Parameter(
                dt, requires_grad=tensor.requires_grad)
        else:
            owner._buffers[leaf] = dt.requires_grad_(tensor.requires_grad)
    return module


__all__ = ["batch_spec", "cache_specs", "distribute_params", "param_specs",
           "to_placements"]
