"""Named ranges at each layer of the port, for `torch.profiler`.

`span(name)` is the one way the port marks a layer. Inside a running
profiler it is `torch.profiler.record_function("repro_torch." + name)`, so
the range lands in the profiler's Chrome trace on the clock of the device
records, and each kernel falls under the spans open on the thread that
launched it (by the launch's correlation id). Outside a profiler it is a
shared no-op, after one check, so a span costs the serving path next to
nothing. A span never synchronises, reads no tensor and changes no result.

Spans, and what each is for:

    repro_torch.dlrm.forward             DLRM.forward: the whole step
                                         (dense_ms is the forward less
                                         ebc.lookup)
    repro_torch.ebc.lookup               EmbeddingBagCollection.forward:
                                         embedding_ms
    repro_torch.embedding_bag.launch     kernel.embedding_bag_cuda, its checks
                                         to the launch: the bag kernel's time
                                         (bag_roofline), and the host work
                                         before each bag kernel
    repro_torch.dlrm.bottom              the bottom MLP tower: mlp_ms
    repro_torch.embedding_bag.ragged_launch
                                         kernel.embedding_bag_ragged_cuda,
                                         its checks to the launch: the
                                         ragged bag kernel's time (tables of
                                         different sizes: dcn_bag_roofline)
    repro_torch.dlrm.interact            DLRM._interact, the dot interaction:
                                         interact_ms
    repro_torch.dlrm.cross               the cross network inside
                                         DLRM._interact (interaction "dcn"):
                                         dcn_cross_ms, dcn_cross_roofline
    repro_torch.dlrm.top                 the top MLP tower: mlp_ms
    repro_torch.hstu.forward             HSTU.forward: the whole step (the
                                         embedding stage's ebc.lookup opens
                                         inside it)
    repro_torch.hstu.time_codes          kernels.hstu_time_codes, once a
                                         forward before the first layer, on
                                         the card: the build of every pair's
                                         time code (counted by the kernel's
                                         CODE_BUILDS beside its LAUNCHES,
                                         and the tiles written by its
                                         CODE_TILES);
                                         inside hstu.forward, so in
                                         dense_ms, and outside
                                         hstu.attention
    repro_torch.hstu.uvqk                an HSTU layer's LayerNorm, its
                                         product to U, V, Q and K and the
                                         SiLU
    repro_torch.hstu.attention           kernels.hstu_attention, its checks
                                         to the launch: the attention
                                         kernel's time (hstu_attn_ms,
                                         hstu_attn_roofline)
    repro_torch.hstu.output              an HSTU layer's LayerNorm of A V,
                                         the gate by U, the product by W_o
                                         and the residual
    repro_torch.hstu.head                the task MLP over the candidates'
                                         last-layer states
    repro_torch.hstu.retrieve            HSTU.retrieve: the whole retrieval
                                         step (the embedding stage, the
                                         encoder's spans above, hstu.query
                                         and hstu.mips open inside it;
                                         counted by HSTU.queries)
    repro_torch.hstu.query               the last action token's state of
                                         each user, gathered and
                                         L2-normalised
    repro_torch.hstu.mips                kernels.mips_topk, its checks to
                                         the launches: the exact scan of
                                         the item rows and the merge of
                                         each block's candidates (mips_ms,
                                         mips_roofline; counted by the
                                         kernel's LAUNCHES, two a call, and
                                         ROWS_SCANNED)
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks `PREFIX + name` while a profiler runs,
    and does nothing otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
