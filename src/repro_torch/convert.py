"""Weights carried across from the TPU path.

`repro.models.dlrm.DLRM.init` returns a tree
`{"bottom": {w_i, b_i}, "embedding": {"tables"}, "top": {w_i, b_i}}`; as
numpy arrays it maps one to one onto the port's state dict. The MLP
weights keep their [in, out] layout (the port computes `x @ w + b`, see
models/layers.py), and tables stored hot-first under pinning are carried
as they are: build the port's model with the same plans.
"""
from __future__ import annotations

import numpy as np
import torch


def dlrm_state_dict_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """The TPU path's DLRM parameter tree (numpy leaves) -> a state dict
    for `repro_torch.models.DLRM`."""
    sd = {}
    for tower in ("bottom", "top"):
        for name, value in tree[tower].items():
            sd[f"{tower}.{name}"] = torch.tensor(np.asarray(value))
    sd["ebc.tables"] = torch.tensor(np.asarray(tree["embedding"]["tables"]))
    return sd


def load_reference_params(model, tree: dict):
    """Copy the TPU path's parameter tree into `model` (in place, onto the
    model's device); shapes and names must match exactly."""
    model.load_state_dict(dlrm_state_dict_from_numpy(tree), strict=True)
    return model
