"""Primitive layers: the init helper, the parameter tree, norms, the
feed-forward variants, RoPE, and the DLRM's MLP tower and cross network.

Weights keep the TPU path's [in, out] layout and compute `x @ w + b`, so a
parameter tree from the JAX package loads as it is (`repro_torch.convert`).
The LM zoo's layers are functions over a `Params` tree, as the JAX
package's are over dicts: `ffn_apply(params, x, act)` reads
`params["wi"]` whichever package made the tree.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import pspec


def dense_init(shape, dtype: torch.dtype, *, generator: torch.Generator,
               device, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (±2 standard deviations)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    if torch.device(device).type == "meta":      # shapes only (registry)
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


class Params(nn.Module):
    """A tree of parameters addressed like the JAX package's dicts:
    `p["mixer"]["wq"]`, `"shared" in p`. Nested dicts become child trees,
    so `state_dict()` names a leaf by its dotted path in the reference's
    tree (`mixer.wq`). Integer leaves are held without a gradient."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(name, nn.Parameter(
                    value, requires_grad=value.is_floating_point()))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[..., n*hd] -> [..., n, hd] (`pspec.reshape`: legal on a DTensor)."""
    return pspec.reshape(t, (*t.shape[:-1], n, hd))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """x·rsqrt(mean(x²)+eps)·(1+w), in f32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Feed-forward variants
# ---------------------------------------------------------------------------

def ffn_init(d_model: int, d_ff: int, act: str, dtype, *,
             generator: torch.Generator, device) -> dict:
    def init(shape):
        return dense_init(shape, dtype, generator=generator, device=device)
    if act == "swiglu":
        return {"wi": init((d_model, d_ff)), "wg": init((d_model, d_ff)),
                "wo": init((d_ff, d_model))}
    return {"wi": init((d_model, d_ff)), "wo": init((d_ff, d_model))}


def ffn_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ params["wi"]
    if act == "swiglu":
        h = F.silu(x @ params["wg"]) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")       # jax.nn.gelu's default
    elif act == "relu_sq":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(act)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# RoPE (incl. the M-RoPE degenerate form for text positions)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] int -> rotated x.

    Each head splits into two halves (x1, x2), not interleaved pairs; the
    angles are f32. M-RoPE note (qwen2-vl): with text-only/stub-vision
    inputs all three position sections (t/h/w) carry the same sequential
    ids, which makes M-RoPE numerically identical to 1-D RoPE; the 1-D form
    is used.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # [hd/2]
    ang = positions[..., None].float() * freqs              # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                      # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class MLPTower(nn.Module):
    """Plain MLP tower (DLRM bottom/top): parameters w{i} [in, out], b{i}."""

    def __init__(self, dims: tuple[int, ...], dtype: torch.dtype, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.num_layers = len(dims) - 1
        for i in range(self.num_layers):
            self.register_parameter(f"w{i}", nn.Parameter(dense_init(
                (dims[i], dims[i + 1]), dtype, generator=generator,
                device=device)))
        for i in range(self.num_layers):
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(
                dims[i + 1], dtype=dtype, device=device)))

    def forward(self, x: torch.Tensor, *, final_act: bool = False):
        for i in range(self.num_layers):
            # sharded (FSDP) weights are gathered whole at use, as ZeRO-3
            # does: a product over a sharded contraction dim would sum in
            # another order than one device's
            x = (x @ pspec.replicate(getattr(self, f"w{i}"))
                 + pspec.replicate(getattr(self, f"b{i}")))
            if i < self.num_layers - 1 or final_act:
                x = torch.relu(x)
        return x


class LowRankCrossNet(nn.Module):
    """DCN V2's cross network in its low-rank form (Wang et al.,
    arXiv:2008.13535; TorchRec's `LowRankCrossNet`): `layers` layers over
    x0 [B, dim], each

        x_{l+1} = x0 * ((x_l @ v_l) @ w_l + b_l) + x_l

    with parameters v{l} [dim, rank], w{l} [rank, dim] and b{l} [dim].
    Initialised as TorchRec does: v and w Xavier-normal, b zero. The
    products are cuBLAS's; the bias rides in the second product
    (`addmm`) and the cross term is one `addcmul`."""

    def __init__(self, dim: int, layers: int, rank: int, dtype: torch.dtype,
                 *, generator: torch.Generator | None, device):
        super().__init__()
        if layers < 1 or rank < 1:
            raise ValueError(f"a cross network needs layers >= 1 and "
                             f"rank >= 1, got {layers} and {rank}")
        self.num_layers = layers
        meta = torch.device(device).type == "meta"
        for i in range(layers):
            for name, shape in ((f"v{i}", (dim, rank)), (f"w{i}", (rank, dim))):
                w = torch.empty(shape, dtype=torch.float32, device=device)
                if not meta:
                    nn.init.xavier_normal_(w, generator=generator)
                self.register_parameter(name, nn.Parameter(w.to(dtype)))
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(
                dim, dtype=dtype, device=device)))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            y = torch.addmm(getattr(self, f"b{i}"),
                            x @ getattr(self, f"v{i}"), getattr(self, f"w{i}"))
            x = torch.addcmul(x, x0, y)
        return x
