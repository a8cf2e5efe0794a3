"""Optimizers tuned for the workloads here.

* adamw            — f32 moments + f32 master copy (highest fidelity)
* adamw_lowmem     — bf16 moments, no master copy
* sgdm             — momentum SGD
* rowwise_adagrad  — per-row accumulator for embedding tables (DLRM standard;
                     one f32 scalar per row instead of per element)

A port of `repro/optim/optimizers.py` with its names and its form:
`init(params) -> state`; `update(params, grads, state) -> (params,
state)`, over (nested) dicts of tensors. The updates are written IN
PLACE under `torch.no_grad()`: the returned params are the tensors given
(a model's own parameters stay its parameters) and the state is updated
in place too, a nested dict of tensors that `CheckpointManager` saves as
it is. Each formula is the reference's, in its order of operations.
Row-wise Adagrad keeps the reference's dense semantics: every row's
accumulator grows by the mean of its squared gradient, zero or not.

`sgdm_update` and `rowwise_adagrad_update` build every temporary before
their first write and allocate nothing after it (SGD's parameter step is
`p.add_(m, alpha=-lr)`, the reference's p - lr·m with no temporary), so
an update that raises, out of memory say, has written nothing; and once
one has written, a later update that allocates nothing cannot fail for
want of memory.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the same-keyed leaves of `rest`
    (nested dicts of tensors), keeping `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _zeros(dtype: torch.dtype | None = None) -> Callable:
    # zeros_like: a DTensor parameter gets state with its placements
    return lambda p: torch.zeros_like(p, dtype=dtype or p.dtype,
                                      memory_format=torch.contiguous_format)


def _bias_correction(beta: float, count: torch.Tensor) -> torch.Tensor:
    """1 - beta ** count in float32 (the reference's `b1 ** c.astype(f32)`)."""
    b = torch.tensor(beta, dtype=torch.float32, device=count.device)
    return 1 - b ** _f32(count)


# -- AdamW ------------------------------------------------------------------

def adamw_init(params: Any) -> dict:
    return {
        "m": _map(_zeros(torch.float32), params),
        "v": _map(_zeros(torch.float32), params),
        "master": _map(lambda p: _f32(p.detach()).clone(), params),
        "count": torch.zeros((), dtype=torch.int32),
    }


@torch.no_grad()
def adamw_update(params, grads, state, *, lr=1e-4, b1=0.9, b2=0.999,
                 eps=1e-8, wd=0.01):
    state["count"] += 1
    c = state["count"]

    def upd(p, g, m, v, master):
        g = _f32(g)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / _bias_correction(b1, c.to(m.device))
        vh = v / _bias_correction(b2, c.to(v.device))
        master.copy_(master - lr * (mh / (torch.sqrt(vh) + eps)
                                    + wd * master))
        p.copy_(master)
    _map(upd, params, grads, state["m"], state["v"], state["master"])
    return params, state


# -- AdamW low-memory ---------------------------------------------------------

def adamw_lowmem_init(params: Any) -> dict:
    return {
        "m": _map(_zeros(torch.bfloat16), params),
        "v": _map(_zeros(torch.bfloat16), params),
        "count": torch.zeros((), dtype=torch.int32),
    }


@torch.no_grad()
def adamw_lowmem_update(params, grads, state, *, lr=1e-4, b1=0.9, b2=0.999,
                        eps=1e-8, wd=0.0):
    state["count"] += 1
    c = state["count"]

    def upd(p, g, m, v):
        g = _f32(g)
        m32 = b1 * _f32(m) + (1 - b1) * g
        v32 = b2 * _f32(v) + (1 - b2) * torch.square(g)
        mh = m32 / _bias_correction(b1, c.to(m.device))
        vh = v32 / _bias_correction(b2, c.to(v.device))
        p32 = _f32(p)
        p.copy_(p32 - lr * (mh / (torch.sqrt(vh) + eps) + wd * p32))
        m.copy_(m32)
        v.copy_(v32)
    _map(upd, params, grads, state["m"], state["v"])
    return params, state


# -- SGD momentum --------------------------------------------------------------

def sgdm_init(params):
    return {"mom": _map(_zeros(), params)}


@torch.no_grad()
def sgdm_update(params, grads, state, *, lr=1e-2, beta=0.9):
    grads = _map(lambda g, m: g.to(m.dtype), grads, state["mom"])

    def upd(p, g, m):
        m.mul_(beta).add_(g)
        p.add_(m, alpha=-lr)
    _map(upd, params, grads, state["mom"])
    return params, state


# -- Row-wise Adagrad (embedding tables) ---------------------------------------

def rowwise_adagrad_init(tables):
    """tables: [..., R, D] -> one accumulator scalar per row."""
    return {"acc": _map(lambda t: torch.zeros(t.shape[:-1],
                                              dtype=torch.float32,
                                              device=t.device), tables)}


@torch.no_grad()
def rowwise_adagrad_update(tables, grads, state, *, lr=0.01, eps=1e-8):
    def new_values(t, g, a):
        g32 = _f32(g)
        a_new = a + torch.square(g32).mean(dim=-1)
        scale = (lr / (torch.sqrt(a_new) + eps)).unsqueeze(-1)
        t_new = (None if t.dtype == torch.float32
                 else torch.addcmul(_f32(t), scale, g32, value=-1.0))
        return g32, a_new, scale, t_new

    def write(t, a, new):
        g32, a_new, scale, t_new = new
        a.copy_(a_new)
        if t_new is None:
            t.addcmul_(scale, g32, value=-1.0)      # t - scale·g, no temporary
        else:
            t.copy_(t_new)
    news = _map(new_values, tables, grads, state["acc"])  # temporaries first
    _map(write, tables, state["acc"], news)
    return tables, state


# -- Gradient compression (distributed-optimization trick) --------------------

def compress_grads(grads, dtype=torch.bfloat16):
    """Cast gradients before the DP all-reduce; returns (compressed, residual
    correction closure state) for error feedback."""
    comp = _map(lambda g: g.to(dtype), grads)
    resid = _map(lambda g, c: _f32(g) - _f32(c), grads, comp)
    return comp, resid


def apply_error_feedback(grads, resid):
    if resid is None:
        return grads
    return _map(lambda g, r: _f32(g) + r, grads, resid)
