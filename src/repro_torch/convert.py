"""Weights carried across from the TPU path.

`repro.models.dlrm.DLRM.init` returns a tree
`{"bottom": {w_i, b_i}, "embedding": {"tables"}, "top": {w_i, b_i}}`; as
numpy arrays it maps one to one onto the port's state dict. The MLP
weights keep their [in, out] layout (the port computes `x @ w + b`, see
models/layers.py), and tables stored hot-first under pinning are carried
as they are: build the port's model with the same plans.

The LM zoo's trees (`TransformerLM.init`, `WhisperModel.init`) keep their
[in, out] layouts too. What differs is the stacking: the reference scans
layer groups over stacked parameters (`params["groups"]["l{j}"]`, leading
axis the group; whisper's `enc`/`dec`, leading axis the layer), and the
port holds one flat layer list. A leaf's dotted path in the reference's
tree is its name in the port's state dict.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.models.dlrm import DLRM
from repro_torch.models.transformer import build_plan


def dlrm_state_dict_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """The TPU path's DLRM parameter tree (numpy leaves) -> a state dict
    for `repro_torch.models.DLRM`."""
    sd = {}
    for tower in ("bottom", "top"):
        for name, value in tree[tower].items():
            sd[f"{tower}.{name}"] = torch.tensor(np.asarray(value))
    sd["ebc.tables"] = torch.tensor(np.asarray(tree["embedding"]["tables"]))
    return sd


def _walk(tree: dict, prefix: str) -> Iterator[tuple[str, object]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def lm_flat_leaves(cfg, tree: dict) -> dict[str, tuple[object, int | None]]:
    """The reference's LM tree -> {port parameter name: (leaf, index)}:
    the port's parameter is `leaf[index]` for a stacked leaf, `leaf`
    itself where the index is None. Leaves may be arrays or shape structs."""
    out: dict[str, tuple[object, int | None]] = {}
    if cfg.is_encoder_decoder:
        depth = {"enc": cfg.num_layers,
                 "dec": cfg.num_decoder_layers or cfg.num_layers}
        for key, value in tree.items():
            if key in depth:
                for i in range(depth[key]):
                    for name, leaf in _walk(value, f"{key}.{i}."):
                        out[name] = (leaf, i)
            else:
                out[key] = (value, None)
        return out
    plan = build_plan(cfg)
    for key in ("embed", "final_norm", "lm_head"):
        if key in tree:
            out[key] = (tree[key], None)
    layer = 0
    for i in range(len(plan.prefix)):
        for name, leaf in _walk(tree["prefix"][i], f"layers.{layer}."):
            out[name] = (leaf, None)
        layer += 1
    for g in range(plan.num_groups):
        for j in range(len(plan.pattern)):
            for name, leaf in _walk(tree["groups"][f"l{j}"],
                                    f"layers.{layer}."):
                out[name] = (leaf, g)
            layer += 1
    for i in range(len(plan.suffix)):
        for name, leaf in _walk(tree["suffix"][i], f"layers.{layer}."):
            out[name] = (leaf, None)
        layer += 1
    return out


def lm_state_dict_from_numpy(cfg, tree: dict) -> dict[str, torch.Tensor]:
    """The reference's `TransformerLM` / `WhisperModel` parameter tree
    (numpy leaves) -> a state dict for the port's model of `cfg`."""
    sd = {}
    for name, (leaf, index) in lm_flat_leaves(cfg, tree).items():
        arr = np.asarray(leaf)
        sd[name] = torch.tensor(arr if index is None else arr[index])
    return sd


def load_reference_params(model, tree: dict):
    """Copy the TPU path's parameter tree into `model` (in place, onto the
    model's device): a DLRM, or an LM of the zoo; shapes and names must
    match exactly."""
    sd = (dlrm_state_dict_from_numpy(tree) if isinstance(model, DLRM)
          else lm_state_dict_from_numpy(model.cfg, tree))
    model.load_state_dict(sd, strict=True)
    return model
