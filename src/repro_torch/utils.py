"""Small helpers shared by the port: devices and dtypes, logging, JSON
files, `shard_map_compat` (the SPMD layer's local region) and tree
arithmetic over nested dicts and lists of tensors."""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:  # pragma: no cover - import-time wiring
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("REPRO_LOGLEVEL", "INFO"))


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`. Asking for CUDA where no card is
    visible raises: the port never moves a GPU request to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions")
    return device


def torch_dtype(name: str) -> torch.dtype:
    """'float32' / 'bfloat16' / ... -> the torch dtype of that name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# -- host form of a dtype ------------------------------------------------------
# numpy has no bfloat16. On the host the port carries a bfloat16 array as
# its 16-bit patterns (np.int16: `tensor.view(torch.int16)`), and on disk
# as numpy's 2-byte void (`|V2`), the descr `np.save` writes for the JAX
# package's `ml_dtypes` bfloat16 arrays, so each package reads the other's
# files. Every other dtype is its own host form.
BF16 = "bfloat16"


def dtype_name(dtype) -> str:
    """The name of a torch dtype, a numpy dtype (`ml_dtypes`' bfloat16 and
    a 2-byte void count as bfloat16) or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    dtype = np.dtype(dtype)
    if dtype.name == BF16 or (dtype.kind == "V" and dtype.itemsize == 2):
        return BF16
    return dtype.name


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype that holds `dtype`'s values on the host."""
    name = dtype_name(dtype)
    return np.dtype(np.int16) if name == BF16 else np.dtype(name)


def host_array(x) -> tuple[np.ndarray, str]:
    """(`x` on the host in its host form, `x`'s dtype name) for a tensor on
    any device or an array-like."""
    if torch.is_tensor(x):
        x = x.detach()
        name = dtype_name(x.dtype)
        if name == BF16:
            x = x.view(torch.int16)
        return x.cpu().numpy(), name
    x = np.asarray(x)
    name = dtype_name(x.dtype)
    return (x.view(np.int16) if name == BF16 else x), name


def to_tensor(arr: np.ndarray, dtype) -> torch.Tensor:
    """A CPU tensor of `dtype` over a host-form array (no copy when `arr`
    is contiguous); a 2-byte void array is read as bfloat16 bits. A 0-d
    array stays 0-d (`np.ascontiguousarray` alone returns it as 1-d)."""
    arr = np.asarray(arr)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype_name(dtype) == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def asdict_shallow(cfg: Any) -> dict:
    """dataclasses.asdict without deep-copying tensor fields."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# -- the SPMD layer's local region ---------------------------------------
def shard_map_compat(*, mesh, in_specs, out_specs):
    """Decorator: run a function written for plain tensors on each rank's
    local shards, the counterpart of `jax.shard_map` over
    `torch.distributed.tensor.experimental.local_map`.

    `in_specs` has one entry an argument and `out_specs` one an output
    (a tuple for several), each a `models.pspec.P` or a tree of them
    whose leaf `P` covers every tensor under it (JAX's prefix rule).
    Inputs are redistributed to their spec when theirs differs (local_map's
    `redistribute_inputs=True`, as shard_map under jit reshards its
    operands); a plain tensor is a global value, replicated on every rank,
    and is split to its spec too; non-tensors pass through. Outputs become
    DTensors with their spec's placements.

    Gradients: an input's gradient is sharded where its spec shards it,
    and a partial sum (`Partial`) on every other mesh dim that an output
    spec shards, since the ranks along such a dim worked on different
    data; elsewhere it is replicated. JAX's `check_vma` has no
    counterpart: local_map does not check that an output declared
    replicated is equal on every rank, so nothing here checks it.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree

    from repro_torch.models.pspec import P, to_placements

    is_spec = lambda s: isinstance(s, P)                    # noqa: E731
    out_tuple = isinstance(out_specs, tuple) and not is_spec(out_specs)
    out_list = list(out_specs) if out_tuple else [out_specs]
    out_pl = [to_placements(s, mesh) for s in out_list]
    split = {m for pl in out_pl for m, p in enumerate(pl)
             if isinstance(p, Shard)}

    def _as_dtensor(t):
        from torch.distributed.tensor import DTensor
        if not torch.is_tensor(t) or isinstance(t, DTensor):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    def leaf_placements(spec, leaf):
        if not torch.is_tensor(leaf):
            return None, None
        pl = to_placements(spec, mesh, leaf.ndim)
        grad = tuple(p if isinstance(p, Shard) else
                     (Partial() if m in split else Replicate())
                     for m, p in enumerate(pl))
        return pl, grad

    def deco(fn):
        def run(*args):
            args = pytree.tree_map(_as_dtensor, args)
            if len(args) != len(in_specs):
                raise TypeError(f"{fn.__name__}: {len(args)} arguments, "
                                f"{len(in_specs)} in_specs")
            flat_pl, flat_grad = [], []
            for arg, spec in zip(args, in_specs):
                leaves = pytree.tree_leaves(arg)
                specs = _broadcast_specs(spec, arg, is_spec)
                for leaf, s in zip(leaves, specs):
                    pl, grad = leaf_placements(s, leaf)
                    flat_pl.append(pl)
                    flat_grad.append(grad)
            # local_map gets the leaves flat: its own pytree (optree where
            # installed) may order a dict's leaves otherwise
            leaves, treedef = pytree.tree_flatten(args)

            def local(*local_leaves):
                return _contiguous_local(
                    fn, *pytree.tree_unflatten(list(local_leaves), treedef))
            return local_map(
                # one output's placements go as a list: local_map reads
                # a tuple as one placements entry per output
                local, out_placements=(tuple(out_pl) if out_tuple
                                       else list(out_pl[0])),
                in_placements=tuple(flat_pl),
                in_grad_placements=tuple(flat_grad),
                device_mesh=mesh, redistribute_inputs=True)(*leaves)
        run.__name__ = fn.__name__
        return run
    return deco


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _contiguous_local(fn, *args):
    """`fn` on local shards, with contiguous outputs and input gradients:
    a DTensor takes its local tensor's layout for its global one, so a
    transposed local result (an einsum's gradient) would break a later
    view."""
    from torch.utils import _pytree as pytree
    args = pytree.tree_map(
        lambda t: (_ContiguousGrad.apply(t)
                   if torch.is_tensor(t) and t.requires_grad else t), args)
    return pytree.tree_map(
        lambda t: t.contiguous() if torch.is_tensor(t) else t, fn(*args))


def _broadcast_specs(spec, tree, is_spec) -> list:
    """One spec a leaf of `tree`, in pytree leaf order: a spec leaf covers
    the whole subtree under it (JAX's prefix rule)."""
    from torch.utils import _pytree as pytree
    if is_spec(spec):
        return [spec] * len(pytree.tree_leaves(tree))
    if isinstance(spec, dict):
        return [s for k in tree for s in
                _broadcast_specs(spec[k], tree[k], is_spec)]
    if isinstance(spec, (list, tuple)):
        return [s for sp, sub in zip(spec, tree) for s in
                _broadcast_specs(sp, sub, is_spec)]
    raise TypeError(f"spec {spec!r} for {type(tree).__name__}")


# -- tree arithmetic ------------------------------------------------------
def _tensor_leaves(tree: Any) -> list:
    from torch.utils import _pytree as pytree
    return [x for x in pytree.tree_leaves(tree) if torch.is_tensor(x)]


def _local(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensors in `tree`; a DTensor counts its local shard
    (one device's bytes, as the dry-run's per-device figures are)."""
    return sum(_local(x).numel() * x.element_size()
               for x in _tensor_leaves(tree))


def tree_param_count(tree: Any) -> int:
    """Elements of the tensors in `tree`, at their global shapes."""
    return sum(x.numel() for x in _tensor_leaves(tree))


def tree_finite(tree: Any) -> bool:
    """Every floating tensor in `tree` finite (True for a tree without one)."""
    return all(bool(torch.isfinite(_local(x)).all())
               for x in _tensor_leaves(tree) if x.is_floating_point())


# -- JSON files ------------------------------------------------------------------
def write_json(path: str, obj: Any) -> None:
    """Write `obj` as indented JSON, atomically (tmp file + `os.replace`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=_json_default)
    os.replace(tmp, path)  # atomic


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def _json_default(o: Any) -> Any:
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if torch.is_tensor(o):
        return o.detach().cpu().tolist()
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    return str(o)


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}PiB"
