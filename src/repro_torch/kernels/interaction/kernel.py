"""DLRM's dot interaction: the CUDA kernel, its plain version and the
dispatch between them.

    z = [x_0 | <x_i, x_j> for 0 <= i < j < F]      F = T + 1

where x_0 is the bottom MLP's output [B, D] and x_1 .. x_T the pooled
bags [B, T, D]; the pairs are in `torch.triu_indices(F, F, 1)` order, as
`jnp.triu_indices` lists them, so z is the top MLP's input row for row.

`csrc/dot_interaction.cu` replaces no TPU kernel (the JAX package's
`DLRM._interact` is plain `jnp`); it replaces the plain version's four
library calls (a cat, the Gram `bmm`, the pair gather and a cat) with one
launch that computes only the pairs and writes z directly. It is built,
bound and launched through `kernels/library.py`, at first use; a failed
build raises.

`dot_interaction` takes the plain version for CPU tensors and the kernel
for CUDA tensors, with no fallback between them. On the CUDA route the
gradient is `DotInteraction`'s backward, the plain math of
`dot_interaction_backward`: the TPU package has no kernel there either.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import library

#: Launches of the CUDA kernel since the count was last set to 0; only
#: `dot_interaction_cuda` adds to it, once a launch, under a lock.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

MAX_FEATURES = 1024        # kMaxFeatures in csrc/dot_interaction.cu


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


LAUNCH_INFO_KEYS = ("registers", "blocks_per_sm", "local_bytes",
                    "static_shared_bytes", "threads",
                    "dynamic_shared_bytes", "path", "chunk", "passes",
                    "grid")   # dot_interaction_last_launch_info


def last_launch_info() -> dict:
    """Registers per thread, resident blocks per SM, spill bytes and the
    launch shape of the instantiation launched last; `path` is 0 for one
    warp a sample, 1 for the tiled path."""
    return library.launch_info("dot_interaction_last_launch_info",
                               LAUNCH_INFO_KEYS)


def dot_interaction_ref(bottom_out: torch.Tensor,
                        pooled: torch.Tensor) -> torch.Tensor:
    """The plain version: bottom_out [B, D], pooled [B, T, D] ->
    [B, D + C(T + 1, 2)] through the Gram matrix of the T + 1 rows."""
    feats = torch.cat([bottom_out[:, None, :], pooled], dim=1)
    gram = torch.bmm(feats, feats.transpose(1, 2))      # [B, F, F]
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    return torch.cat([bottom_out, gram[:, iu, ju]], dim=1)


def dot_interaction_backward(bottom_out: torch.Tensor, pooled: torch.Tensor,
                             grad: torch.Tensor):
    """The gradients of (bottom_out, pooled) from the gradient of z: the
    pairs' part scattered into an upper triangle S [B, F, F], and
    d feats = (S + Sᵀ) @ feats; bottom_out also takes z's first D
    columns."""
    feats = torch.cat([bottom_out[:, None, :], pooled], dim=1)
    batch, f, dim = feats.shape
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    s = grad.new_zeros((batch, f, f))
    s[:, iu, ju] = grad[:, dim:]
    g = torch.bmm(s + s.transpose(1, 2), feats)
    return grad[:, :dim] + g[:, 0], g[:, 1:]


def dot_interaction_cuda(bottom_out: torch.Tensor,
                         pooled: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA kernel.

    bottom_out: [B, D] float32 or bfloat16, contiguous, on a CUDA device
    pooled:     [B, T, D] of the same type, contiguous, on the same device,
                T + 1 <= MAX_FEATURES
    returns:    [B, D + C(T + 1, 2)] in their type
    """
    if (bottom_out.dtype not in library.DTYPE_CODES
            or pooled.dtype != bottom_out.dtype):
        raise ValueError(f"bottom_out and pooled must both be float32 or "
                         f"bfloat16, got {bottom_out.dtype} and "
                         f"{pooled.dtype}")
    if (bottom_out.dim() != 2 or pooled.dim() != 3
            or pooled.shape[0] != bottom_out.shape[0]
            or pooled.shape[2] != bottom_out.shape[1]
            or bottom_out.shape[1] < 1):
        raise ValueError(f"want bottom_out [B, D] and pooled [B, T, D] with "
                         f"D >= 1, got {tuple(bottom_out.shape)} and "
                         f"{tuple(pooled.shape)}")
    if not (bottom_out.is_contiguous() and pooled.is_contiguous()):
        raise ValueError("bottom_out and pooled must be contiguous")
    batch, num_tables, dim = pooled.shape
    features = num_tables + 1
    if features > MAX_FEATURES:
        raise ValueError(f"T + 1 = {features} features; the kernel takes "
                         f"at most {MAX_FEATURES}")
    if not (bottom_out.is_cuda and pooled.device == bottom_out.device):
        raise ValueError(f"dot_interaction_cuda needs both on one CUDA "
                         f"device, got {bottom_out.device} and "
                         f"{pooled.device}; CPU tensors go to "
                         f"dot_interaction_ref")
    out = torch.empty((batch, dim + features * (features - 1) // 2),
                      dtype=bottom_out.dtype, device=bottom_out.device)
    if batch == 0:
        return out
    library.launch(
        "dot_interaction_launch", bottom_out.device,
        bottom_out.data_ptr(), pooled.data_ptr(), out.data_ptr(), batch,
        features, dim, library.DTYPE_CODES[bottom_out.dtype])
    _count_launch()
    return out


class DotInteraction(torch.autograd.Function):
    """The kernel forward with the plain backward."""

    @staticmethod
    def forward(ctx, bottom_out, pooled):
        ctx.save_for_backward(bottom_out, pooled)
        return dot_interaction_cuda(bottom_out, pooled)

    @staticmethod
    def backward(ctx, grad):
        return dot_interaction_backward(*ctx.saved_tensors, grad)


def dot_interaction(bottom_out: torch.Tensor,
                    pooled: torch.Tensor) -> torch.Tensor:
    """The dot interaction: the kernel for CUDA tensors, the plain version
    for CPU tensors. Either takes any layout: the kernel's inputs are made
    contiguous first (the local shards of the SPMD steps are strided views;
    the serving path's are contiguous already, and pass as they are)."""
    if bottom_out.is_cuda:
        return DotInteraction.apply(bottom_out.contiguous(),
                                    pooled.contiguous())
    return dot_interaction_ref(bottom_out, pooled)
