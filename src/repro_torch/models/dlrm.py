"""DLRM (Naumov et al.) — the paper's model (§II-A, Fig. 2; config from §V).

Stages: Bottom MLP (continuous features) | Embedding stage (categorical) |
Feature interaction (pairwise dot product, concatenation, or DCN V2's
low-rank cross network) | Top MLP -> CTR logit.

The embedding stage is an EmbeddingBagCollection (core/embedding.py) — the
paper's technique (the prefetching CUDA embedding-bag kernel) plugs in
through its EmbeddingStageConfig. The MLPs are plain matrix products
(cuBLAS on the card); the dot interaction is one CUDA kernel on the card
(kernels/interaction) and its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.embedding import EmbeddingBagCollection, EmbeddingStageConfig
from repro_torch.kernels.interaction import dot_interaction
from repro_torch.models import pspec
from repro_torch.models.layers import LowRankCrossNet, MLPTower
from repro_torch.models.pspec import P
from repro_torch.tracing import span
from repro_torch.utils import resolve_device, shard_map_compat, torch_dtype


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    # paper §V defaults
    dense_features: int = 13
    bottom_mlp: tuple[int, ...] = (1024, 512, 128, 128)
    top_mlp: tuple[int, ...] = (128, 64, 1)
    embedding: EmbeddingStageConfig = EmbeddingStageConfig()
    interaction: str = "dot"      # dot | cat | dcn
    dtype: str = "float32"
    # the "dcn" interaction: a low-rank cross network (DCN V2) over the
    # concatenated features, of this many layers and this rank
    dcn_layers: int = 3
    dcn_rank: int = 512

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def interaction_dim(self) -> int:
        t = self.embedding.num_tables + 1      # +1: bottom MLP output
        if self.interaction == "dot":
            return self.bottom_mlp[-1] + t * (t - 1) // 2
        return self.bottom_mlp[-1] * t     # cat, and dcn's cross width


class DLRM(nn.Module):
    """`DLRM(cfg, device=..., seed=...)` makes random weights on `device`
    from a `torch.Generator`; `repro_torch.convert.load_reference_params`
    loads the TPU path's weights instead, and `tables=` hands the
    embedding collection existing tables; `device="meta"` builds the
    shapes alone. Submodules: `bottom`, `ebc`, `top`, and `cross` (the
    `LowRankCrossNet`) when `cfg.interaction` is "dcn"."""

    def __init__(self, cfg: DLRMConfig, plans=None, *, device="cuda",
                 seed: int = 0, tables: torch.Tensor | None = None):
        super().__init__()
        if cfg.bottom_mlp[-1] != cfg.embedding.dim:
            raise ValueError("bottom MLP output must match embedding dim "
                             "for dot interaction")
        if cfg.interaction not in ("dot", "cat", "dcn"):
            raise ValueError(f"unknown interaction {cfg.interaction!r}: "
                             f"dot, cat or dcn")
        self.cfg = cfg
        device = resolve_device(device)
        gen = (None if device.type == "meta"      # shapes only
               else torch.Generator(device=device).manual_seed(seed))
        dt = cfg.torch_dtype
        self.bottom = MLPTower((cfg.dense_features, *cfg.bottom_mlp), dt,
                               generator=gen, device=device)
        self.ebc = EmbeddingBagCollection(cfg.embedding, plans,
                                          device=device, generator=gen,
                                          tables=tables)
        self.top = MLPTower((cfg.interaction_dim(), *cfg.top_mlp), dt,
                            generator=gen, device=device)
        if cfg.interaction == "dcn":
            self.cross = LowRankCrossNet(cfg.interaction_dim(),
                                         cfg.dcn_layers, cfg.dcn_rank, dt,
                                         generator=gen, device=device)

    @property
    def device(self) -> torch.device:
        """Where the MLPs run and the pooled embeddings land (the tables
        of a host-backed storage backend stay on the host)."""
        return self.ebc.device

    def _interact(self, bottom_out: torch.Tensor, pooled: torch.Tensor):
        """bottom_out: [B, D]; pooled: [B, T, D] -> interaction features:
        the dot interaction's pairs, the concatenation [B, (T+1)·D]
        ("cat"), or the cross network over it ("dcn", under the span
        `dlrm.cross`). On DTensors each rank interacts its own rows (a
        `shard_map_compat` region over bottom_out's batch shards): the
        interaction kernel takes plain contiguous tensors (and the plain
        version's pair gather, on the CPU, has a backward with no DTensor
        sharding rule in every torch release)."""
        if pspec.is_dtensor(bottom_out):
            b_ax = pspec.spec_of(bottom_out)[0]

            @shard_map_compat(mesh=bottom_out.device_mesh,
                              in_specs=(P(b_ax, None), P(b_ax, None, None)),
                              out_specs=P(b_ax, None))
            def local(bottom_l, pooled_l):
                return self._interact(bottom_l, pooled_l)

            return local(bottom_out, pooled)
        with span("dlrm.interact"):
            if self.cfg.interaction == "dot":
                # [B, D + C(T+1, 2)], pairs row-major as jnp.triu_indices
                return dot_interaction(bottom_out, pooled)
            feats = torch.cat([bottom_out[:, None, :], pooled], dim=1)
            feats = feats.reshape(feats.shape[0], -1)
            if self.cfg.interaction == "cat":
                return feats
            with span("dlrm.cross"):
                return self.cross(feats)

    def forward(self, dense: torch.Tensor, sparse_indices: torch.Tensor,
                sparse_weights: torch.Tensor | None = None) -> torch.Tensor:
        """dense: [B, F]; sparse_indices: [B, T, L] -> CTR logits [B].

        With tables of different sizes (a `RaggedStageConfig`),
        sparse_indices is [B, sum(table_pooling)] int32: table t's ids sit
        at columns [off_t, off_t + L_t), off_t the sum of the bag sizes
        before it, and each lies in [0, table_rows[t])."""
        with span("dlrm.forward"):
            pooled = self.ebc(sparse_indices, sparse_weights)
            return self.forward_from_pooled(dense, pooled)

    def forward_from_pooled(self, dense: torch.Tensor,
                            pooled: torch.Tensor) -> torch.Tensor:
        """Everything after the embedding stage: pooled [B, T, D] -> logits.

        Split out so a host-backed storage can run its lookup on the host
        and feed the pooled rows into this remainder.
        """
        with span("dlrm.bottom"):
            bottom = self.bottom(dense, final_act=True)
        z = self._interact(bottom, pooled.to(bottom.dtype))
        with span("dlrm.top"):
            return self.top(z)[:, 0]

    def embedding_only(self, sparse_indices: torch.Tensor) -> torch.Tensor:
        """Embedding stage in isolation (paper's embedding-only latency)."""
        return self.ebc(sparse_indices)

    def loss(self, dense: torch.Tensor, sparse_indices: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Mean binary cross-entropy of the logits against `labels` [B]."""
        return bce_with_logits(self(dense, sparse_indices), labels)


def bce_with_logits(logit: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """mean(max(z, 0) - z·y + log1p(exp(-|z|))): the TPU path's stable
    formula, term for term."""
    return torch.mean(torch.clamp_min(logit, 0) - logit * labels
                      + torch.log1p(torch.exp(-torch.abs(logit))))
