"""Trace-time sharding hints for model internals, on DTensor.

The counterpart of the JAX package's `models/pspec.py`. Steps set the
active mesh with `use_mesh(...)`; model code pins the layouts it wants
with `constrain(...)`. Every hint is an identity when no mesh is active
or when the tensor is a plain tensor (one device, the CPU tests), and
`DTensor.redistribute` to the spec's placements for a DTensor.

A spec is a `P`: a tuple subclass holding one entry a tensor dim, each
None, a mesh axis name, or a tuple of axis names, exactly as JAX's
`PartitionSpec` holds them (the port imports no JAX). `to_placements`
turns one into DTensor placements, one a mesh dim.

Two axes on one tensor dim (`table_axes`' `("model", "data")`): JAX splits
the dim model-major, DTensor splits it over the mesh dims in mesh order
(data-major on a `(data, model)` mesh). The per-device shapes agree either
way; which rank owns which block may not. Compare specs and local shapes
across the two packages, never owner ranks.

Two hints of the JAX package have no counterpart, as nothing would call
them: `set_kv_fallback` (the JAX package never leaves its default 'seq'
mode, which `kv_cache_spec` keeps) and `constrain_scores` (the port's
decode scores are plain tensors inside the per-rank attention region).

The KV-cache rule here is THE rule: launch/sharding.cache_specs delegates
to it, so the step's cache layout and the in-model constraints agree.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


class P(tuple):
    """PartitionSpec: `P("data", None)`, `P(("model", "data"))`, `P()`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh (the JAX
    rules index `mesh.shape[axis]`; a DeviceMesh's `shape` is a tuple)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the active mesh of the `constrain_*` hints, inside an
    `spmd(mesh)` region."""
    tok = _MESH.set(mesh)
    try:
        with spmd(mesh):
            yield
    finally:
        _MESH.reset(tok)


@contextlib.contextmanager
def spmd(mesh):
    """With a mesh, a region where DTensor ops take plain tensors (RoPE
    angles, masks, positions: the same on every rank) as replicated
    (`implicit_replication`, made safe to nest); without one, nothing.
    A backward pass through DTensors runs inside one too."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def current_mesh():
    return _MESH.get()


def _dp(mesh) -> tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def _fits(mesh, n: int, axes) -> bool:
    if not axes:
        return False
    shape = mesh_axes(mesh)
    size = math.prod(shape[a] for a in axes)
    return size > 1 and n % size == 0


def axis_if(mesh, n: int, *prefs):
    """First preference (a tuple of axis names) whose size, above 1,
    divides n: its one name or the tuple; else None."""
    axes = mesh_axes(mesh)
    for p in prefs:
        p = tuple(a for a in p if a in axes)
        if _fits(mesh, n, p):
            return p if len(p) > 1 else p[0]
    return None


# Parallel policy: 'tp_fsdp' (Megatron TP over `model` + FSDP over dp) or
# 'fsdp_only' (every axis is data parallelism + ZeRO-3), as in the JAX
# package; process-global there too, so a caller that switches it resets it.
_PARALLEL_MODE = "tp_fsdp"


def set_parallel_mode(mode: str):
    global _PARALLEL_MODE
    if mode not in ("tp_fsdp", "fsdp_only"):
        raise ValueError(f"parallel mode {mode!r}")
    _PARALLEL_MODE = mode


def parallel_mode() -> str:
    return _PARALLEL_MODE


def all_axes(mesh) -> tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data", "model") if a in axes)


def batch_axes(mesh, b: int):
    if _PARALLEL_MODE == "fsdp_only":
        return axis_if(mesh, b, all_axes(mesh), _dp(mesh))
    return axis_if(mesh, b, _dp(mesh))


def kv_cache_spec(mesh, shape) -> P:
    """[B, S, KV, hd]: batch over dp; kv heads over model when divisible,
    else the sequence over the free axes, else the head dim over model
    (the JAX package's default 'seq' fallback)."""
    b_ax = batch_axes(mesh, shape[0])
    kv_ax = axis_if(mesh, shape[2], ("model",))
    hd_ax = None
    s_ax = None
    if kv_ax is None:
        s_ax = _free_seq_axes(mesh, shape[1], b_ax)
        if s_ax is None:
            hd_ax = axis_if(mesh, shape[3], ("model",))
    return P(b_ax, s_ax, kv_ax, hd_ax)


def mla_cache_spec(mesh, shape) -> P:
    """[B, S, dim]: batch over dp, sequence over the free axes."""
    b_ax = batch_axes(mesh, shape[0])
    return P(b_ax, _free_seq_axes(mesh, shape[1], b_ax), None)


def _free_seq_axes(mesh, s_len: int, b_ax):
    axes = mesh_axes(mesh)
    used = set(b_ax if isinstance(b_ax, tuple) else
               ((b_ax,) if b_ax else ()))
    free = [a for a in ("model", "pod", "data")
            if a in axes and a not in used]
    return axis_if(mesh, s_len, tuple(free), *[(f,) for f in free])


def to_placements(spec: P, mesh, ndim: int | None = None) -> tuple:
    """DTensor placements (one a mesh dim) of `spec` on `mesh`: Shard(i)
    on each mesh dim of size above 1 that tensor dim i names, Replicate
    elsewhere (a shard over one rank is the whole tensor, and DTensor's
    view rules treat a dim of size 1 sharded over it as one to squeeze).
    A dim that names several axes is split over them in mesh order (see
    the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than ndim {ndim}")
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            m = names.index(a)
            if mesh.shape[m] > 1:
                out[m] = Shard(i)
    return tuple(out)


def spec_of(x) -> P:
    """The P of a DTensor's placements (the inverse of `to_placements`;
    Partial counts as unsharded)."""
    entries: list = [[] for _ in range(x.ndim)]
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            entries[p.dim].append(name)
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries))


def constrain(x, spec: P):
    """`x` redistributed to `spec` on the active mesh (a DTensor), else
    `x` itself."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = to_placements(spec, mesh, x.ndim)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def constrain_kv(k):
    mesh = current_mesh()
    if mesh is None:
        return k
    return constrain(k, kv_cache_spec(mesh, k.shape))


def constrain_mla(ckv):
    mesh = current_mesh()
    if mesh is None:
        return ckv
    return constrain(ckv, mla_cache_spec(mesh, ckv.shape))


def table_axes(mesh, t: int):
    """DLRM stacked-table dim: all chips when divisible, else TP only."""
    return axis_if(mesh, t, ("model", "data"), ("model",))


def constrain_tablewise(x, t_dim: int = 0):
    """Pin [T, ...] tensors to whole-table sharding (a2a lookup plan)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = [None] * x.ndim
    spec[t_dim] = table_axes(mesh, x.shape[t_dim])
    return constrain(x, P(*spec))


def constrain_activation(x):
    """[B, S, d] block boundary: batch over dp, rest replicated."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return constrain(x, P(batch_axes(mesh, x.shape[0]), None, None))


def constrain_channels(x, channel_dim: int = -1):
    """[B, ..., C]: batch over the policy's axes, the channels over
    `model` where they divide (`region_axes`), the rest whole: the
    layout a row-parallel product reads and a column-parallel one
    writes. Pins a row-parallel product's partial sum to a
    reduce-scatter over its channels before an elementwise op, where
    DTensor would otherwise scatter it over the sequence; and a whole
    input of a row-parallel product to its channel shards, whose weight
    gradient torch 2.11 would otherwise compute whole on every rank."""
    if current_mesh() is None or not is_dtensor(x):
        return x
    b_ax, c_ax = region_axes(x, channel_dim)
    spec = [None] * x.ndim
    spec[0], spec[channel_dim] = b_ax, c_ax
    return constrain(x, P(*spec))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate(x):
    """`x` replicated on every mesh dim (an all-gather of what is
    sharded); `x` itself when it is a plain tensor. Callers state why a
    replica is the honest layout where they use it."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def reduce_partial(x):
    """A DTensor's partial placements reduced (to Replicate), its shards
    kept; a plain tensor as it is. The gradient goes back replicated
    where it arrives partial: DTensor cannot turn a partial sum into the
    masked partial of an embedding's or a gather's backward."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return _ReducePartial.apply(x)


def _reduced(x):
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


class _ReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _reduced(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad)


def region_axes(x, channel_dim: int):
    """(batch axes, channel axes) of a per-rank region over `x` [B, ...,
    C, ...]: under an active mesh the policy's (batch over `batch_axes`,
    the channel dim, heads say, over `model` where it divides and the
    batch does not use it); else `x`'s own shards of those dims."""
    mesh = current_mesh()
    if mesh is None:
        spec = spec_of(x)
        return spec[0], spec[channel_dim]
    b_ax = batch_axes(mesh, x.shape[0])
    used = b_ax if isinstance(b_ax, tuple) else (b_ax,)
    c_ax = (None if "model" in used
            else axis_if(mesh, x.shape[channel_dim], ("model",)))
    return b_ax, c_ax


def gather_last(x, idx):
    """`x[..., idx]` along the last dim: torch.gather of idx[..., None].
    On a DTensor the masked partial sum of a vocab-sharded gather is
    reduced at the gather's own shape, and the backward is one-hot rows
    laid out as `idx` (torch's gather backward makes zeros at `x`'s
    global shape, replicated, on every rank). Under `spmd` only: the
    backward compares with a plain `arange`."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    return _GatherLast.apply(x, idx)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = x.shape[-1], x.dtype
        return _reduced(torch.gather(x, -1, idx[..., None]))[..., 0]

    @staticmethod
    def backward(ctx, grad):
        # one-hot rows times the gradient: laid out as idx (batch shards),
        # whole along the last dim; a partial-sum x takes it whole too
        (idx,) = ctx.saved_tensors
        hit = idx[..., None] == torch.arange(ctx.n, device=idx.device)
        return hit.to(ctx.dtype) * _reduced(grad)[..., None], None


def gather_table(table):
    """An embedding table [V, d] as a lookup reads it: its non-vocab shards
    gathered (the FSDP all-gather at use), its vocab shards kept. DTensor's
    masked lookup over a vocab-sharded table goes wrong when the table is
    also sharded on d on a mesh dim that shards the ids."""
    if not is_dtensor(table):
        return table
    from torch.distributed.tensor import Replicate
    placements = [Replicate() if p.is_shard() and p.dim != 0 else p
                  for p in table.placements]
    # the vocab kept sharded over one mesh dim only (the last): over
    # several, DTensor's masked lookup reuses one mask buffer per mesh
    # dim, and comparing masks has no meta kernel (the dry-run's)
    vocab = [m for m, p in enumerate(placements) if p.is_shard(0)]
    for m in vocab[:-1]:
        placements[m] = Replicate()
    if placements == list(table.placements):
        return table
    return table.redistribute(table.device_mesh, placements)


def reshape(x, shape):
    """`x.reshape(shape)`, and for a DTensor one that DTensor refuses (a
    sharded dim split into groups that the shards cut through: a head
    split over more ranks than heads, or its gradient) done after
    gathering the sharded dims from the first changed dim on; the
    backward pass goes the same way. The gather is what such a view
    costs: GSPMD shards a fraction of a head where DTensor cannot."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


def _view(x, shape):
    """(the view, whether `x` had to be gathered for it)."""
    # contiguous first: a local shard may not be, though the DTensor's
    # global strides say so, and DTensor reshapes by a local view
    x = x.contiguous()
    try:
        return x.reshape(shape), False
    except RuntimeError:
        pass
    from torch.distributed.tensor import Replicate
    first = next((i for i, (a, b) in enumerate(zip(x.shape, shape))
                  if a != b), 0)
    x = x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard() and p.dim >= first else p
        for p in x.placements])
    return x.reshape(shape), True


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        out, gathered = _view(x, shape)
        # a gathered forward takes its gradient back to the input's
        # shards (the gather's adjoint): left whole, the producer's
        # weight gradient would be computed whole on every rank
        ctx.in_placements = tuple(x.placements) if gathered else None
        return out

    @staticmethod
    def backward(ctx, grad):
        grad, _ = _view(grad, ctx.in_shape)
        if ctx.in_placements is not None:
            target = [p if p.is_shard() else g for p, g in
                      zip(ctx.in_placements, grad.placements)]
            if target != list(grad.placements):
                grad = grad.redistribute(grad.device_mesh, target)
        return grad, None


def write_at(buf, new, pos: int, dim: int = 1):
    """`buf.narrow(dim, pos, n) = new` in place (a cache write at a host
    position), and `buf`. For a DTensor `buf` the write is done on each
    rank's local shard: `new` is redistributed to `buf`'s placements but
    whole along `dim`, and each rank copies the part of the window that
    falls in its own block of `dim` (a sequence-sharded cache). A slice
    of a sharded dim is not a view in DTensor, so an assignment through
    one would write a copy."""
    n = new.shape[dim]
    if not is_dtensor(buf):
        buf.narrow(dim, pos, n).copy_(new.to(buf.dtype))
        return buf
    from torch.distributed.tensor import DTensor, Replicate
    mesh = buf.device_mesh
    if not is_dtensor(new):          # a plain value: the same on every rank
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    target = [Replicate() if p.is_shard(dim) else p for p in buf.placements]
    if list(new.placements) != target:
        new = new.redistribute(mesh, target)
    local, local_new = buf.to_local(), new.to_local().to(buf.dtype)
    block = 0
    coord = mesh.get_coordinate()
    for m, p in enumerate(buf.placements):
        if p.is_shard(dim):
            block = block * mesh.size(m) + coord[m]
    size = local.shape[dim]
    lo, hi = max(pos, block * size), min(pos + n, (block + 1) * size)
    if lo < hi:
        local.narrow(dim, lo - block * size, hi - lo).copy_(
            local_new.narrow(dim, lo - pos, hi - lo))
    return buf
