"""Op-level cost model for the three-term roofline.

The JAX package walks XLA's HLO text; the port has no HLO. What it counts
instead are the aten ops a call dispatches: `OpCost` is a
`TorchDispatchMode`, so running a function under it (on meta tensors, a
full-width shape allocates nothing) sees every op after autograd and the
composite decompositions (`einsum` arrives as `bmm`, `x @ w` as `mm`).

  flops            — 2*M*N*K per mm / addmm / bmm / baddbmm.
  bytes            — the eager program's HBM traffic, op by op: one read of
                     each tensor input and one write of each output. Views
                     (view, reshape's alias, expand, permute, transpose,
                     slice, select, alias, detach, ...) and `_unsafe_view`
                     are free; a gather (index, index_select, gather,
                     embedding) reads the rows it returns, not its table.
                     An in-place write into a slice or by index
                     (the KV cache's `copy_` into a view, `index_put_`,
                     `index_copy_`) is charged the region it updates, not
                     the whole buffer: the counterpart of the HLO parser's
                     dynamic-update-slice rule.
  collective_bytes — operand bytes of the `_c10d_functional` collectives
                     (all_reduce, all_gather_into_tensor, reduce_scatter_
                     tensor, all_to_all_single, broadcast; their autograd
                     forms too).

Per device under DTensor. The mode sees a DTensor op once, at its global
shapes, and the collectives DTensor inserts as plain ops at local shapes
(already one device's). So a DTensor op's flops are its global flops
divided by the product of the sizes of the mesh dims on which its output
is `Shard` or `Partial` (each rank computes its block, or its partial
sum; a replicated output means every rank did the whole product), and
its bytes count each DTensor's local shard. One program over a
(2, 4) mesh thus counts one device's eighth of a product that divides.

Eager PyTorch does not fuse, so `bytes` is what the eager program moves,
not the least a fused program could move; state that least apart (a floor:
each weight read once, plus the cache, plus the output).

`xla_cost_analysis` has no counterpart: it normalises an XLA API
(`Compiled.cost_analysis()`) that the port does not have.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline.hw import (HBM_BW, NVLINK_BW_PER_DIRECTION,
                                     PEAK_FLOPS_BF16)

aten = torch.ops.aten

# not views by schema, but reshapes of a fresh result: no traffic
_FREE = {aten._unsafe_view.default, aten.lift_fresh.default,
         aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten._local_scalar_dense.default}
# in-place writes by index: the region is the size of the values written
_INDEXED_WRITES = {aten.index_put_.default, aten._index_put_impl_.default,
                   aten.index_copy_.default, aten.index_add_.default,
                   aten.scatter_.src, aten.scatter_add_.default}
# gathers read the rows they return, not the whole table
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# in-place writes that do not read what they overwrite
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}
_COLLECTIVES = {"all_reduce", "all_reduce_coalesced",
                "all_gather_into_tensor", "all_gather_into_tensor_coalesced",
                "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                "all_to_all_single", "broadcast"}


def _numel(t: torch.Tensor) -> int:
    """Elements on this device: a DTensor's local shard."""
    return t._local_tensor.numel() if isinstance(t, DTensor) else t.numel()


def _nbytes(t: torch.Tensor) -> int:
    return _numel(t) * t.element_size()


def _flop_share(out) -> float:
    """1 / the product of the mesh-dim sizes on which a DTensor output is
    sharded or partial (1 for plain tensors): see the module docstring."""
    for t in tree_flatten(out)[0]:
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            n = 1
            for m, p in enumerate(t.placements):
                if p.is_shard() or p.is_partial():
                    n *= mesh.size(m)
            return 1.0 / n
    return 1.0


def _mm_flops(func, args) -> float:
    """2*M*N*K for the matrix products (their operand shapes)."""
    if func in (aten.mm.default,):
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2.0 * m * n * k
    if func in (aten.addmm.default,):
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2.0 * m * n * k
    if func in (aten.bmm.default,):
        (b, m, k), n = args[0].shape, args[1].shape[2]
        return 2.0 * b * m * n * k
    if func in (aten.baddbmm.default,):
        (b, m, k), n = args[1].shape, args[2].shape[2]
        return 2.0 * b * m * n * k
    return 0.0


class OpCost(TorchDispatchMode):
    """Counts flops, bytes and collective bytes of everything dispatched
    while it is active:

        with OpCost() as cost:
            model.prefill(tokens, cache)
        cost.total()   # {"flops", "bytes", "collective_bytes", ...}
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, float] = {}
        self.bytes_by_op: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = str(func.overloadpacket).split(".")[-1]
        before = self.bytes
        self._charge(func, name, args, kwargs, out)
        self.bytes_by_op[name] = (self.bytes_by_op.get(name, 0.0)
                                  + self.bytes - before)

    def _charge(self, func, name, args, kwargs, out) -> None:
        if func.namespace in ("_c10d_functional",
                              "_c10d_functional_autograd"):
            if name in _COLLECTIVES:
                moved = sum(_nbytes(t) for t in tree_flatten(args)[0]
                            if isinstance(t, torch.Tensor))
                self.collectives[name] = self.collectives.get(name, 0.0) \
                    + moved
            return
        if func.is_view or func in _FREE:
            return
        self.flops += _mm_flops(func, args) * _flop_share(out)
        schema = func._schema
        mutated = []
        reads = 0
        for i, a in enumerate(schema.arguments):
            value = args[i] if i < len(args) else kwargs.get(a.name)
            tensors = [t for t in tree_flatten(value)[0]
                       if isinstance(t, torch.Tensor)]
            if a.alias_info is not None and a.alias_info.is_write:
                mutated += tensors
            else:
                reads += sum(_nbytes(t) for t in tensors)
        written = sum(_nbytes(t) for t in tree_flatten(out)[0]
                      if isinstance(t, torch.Tensor))
        if func in _GATHERS:           # the indices, the rows, the result
            self.bytes += reads - _nbytes(args[0]) + 2 * written
            return
        if not mutated:                       # out of place
            self.bytes += reads + written
            return
        if func in _INDEXED_WRITES:
            region = (_numel(_indexed_values(func, args, kwargs))
                      * mutated[0].element_size())
            self.bytes += reads + region * (
                2 if _accumulates(func, args, kwargs) else 1)
            return
        written = sum(_nbytes(t) for t in mutated)
        write_only = func in _WRITE_ONLY or all(
            a.name == "out" for a in schema.arguments
            if a.alias_info is not None and a.alias_info.is_write)
        self.bytes += reads + written * (1 if write_only else 2)

    def total(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": sum(self.collectives.values()),
                "collective_breakdown": dict(self.collectives)}


def _indexed_values(func, args, kwargs) -> torch.Tensor:
    if func in (aten.index_put_.default, aten._index_put_impl_.default):
        return args[2]
    if func in (aten.index_copy_.default, aten.index_add_.default):
        return args[3]
    return args[3] if len(args) > 3 else kwargs["src"]   # scatter_(src)


def _accumulates(func, args, kwargs) -> bool:
    if func in (aten.index_add_.default, aten.scatter_add_.default):
        return True
    if func in (aten.index_put_.default, aten._index_put_impl_.default):
        return bool(args[3] if len(args) > 3
                    else kwargs.get("accumulate", False))
    return False


def roofline_terms(cost: dict, *, num_chips: int) -> dict:
    """The three roofline terms (seconds) of one device's `OpCost.total()`."""
    compute_s = cost["flops"] / PEAK_FLOPS_BF16
    memory_s = cost["bytes"] / HBM_BW
    collective_s = cost["collective_bytes"] / NVLINK_BW_PER_DIRECTION
    dominant = max(
        [("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)], key=lambda kv: kv[1])[0]
    return {
        "per_device_flops": cost["flops"],
        "per_device_bytes": cost["bytes"],
        "per_device_collective_bytes": cost["collective_bytes"],
        "collective_breakdown": cost["collective_breakdown"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "num_chips": num_chips,
    }
