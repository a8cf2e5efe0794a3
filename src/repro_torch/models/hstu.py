"""HSTU generative ranking (Zhai et al., "Actions Speak Louder than Words:
Trillion-Parameter Sequential Transducers for Generative Recommendations",
ICML 2024, arXiv:2402.17152, §3; github.com/facebookresearch/
generative-recommenders).

A user's sequence interleaves each engagement's item token and action
token, and the user's m candidates follow as item tokens alone: a
candidate's action is what is predicted. Every layer of the encoder is

    U, V, Q, K = split(SiLU(LN(X) @ W_uvqk))          no bias
    A_ij = SiLU(alpha q_i.k_j + rab(i, j)) / N * mask(i, j)
    X'   = X + (LN(A V) * U) @ W_o + b_o              LNs without affine

with rab(i, j) = p[j - i + N - 1] + w[bucket(t_i - t_j)], shared by the
heads, and a mask that lets a history token see the history causally and a
candidate the whole history and itself (M-FALCON's target-aware pass, §3.4,
all m candidates in one micro-batch). Each candidate's last-layer state
goes through a task MLP to one logit.

The tokens' embeddings are single-row lookups into an item table and an
action table, through `EmbeddingBagCollection` on a `RaggedStageConfig` of
the two tables with bags of one row (the ragged bag kernel on the card; a
candidate also looks up action row 0, which is dropped). The attention is
`kernels.hstu_attention` (the CUDA kernel on the card, its plain version on
the CPU); on the card each pair's time bucket and mask are coded once a
forward (`hstu_time_codes`) and read by every layer. The products are
cuBLAS's, in float32.

Rows of a batch: every user's history tokens, in user order, then every
user's candidates, in user order (`kernels.hstu_attention.JaggedLayout`).

Retrieval (§2.1; the reference code's public experiments; config
`hstu-retrieval`): a batch of histories alone goes through the same
encoder, each user's last action token's state, L2-normalised, is the
query, and `HSTU.retrieve` returns the K item rows of largest dot product
with it, scanned in place in the embedding stage's table by
`kernels.mips_topk` (the CUDA kernel on the card, its plain version on the
CPU). A retrieval configuration has no task MLP.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.embedding import EmbeddingBagCollection, RaggedStageConfig
from repro_torch.kernels.hstu_attention import (JaggedLayout, bucket_thresholds,
                                                hstu_attention,
                                                hstu_time_codes)
from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.models.layers import MLPTower
from repro_torch.tracing import span
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class HSTUConfig:
    """HSTU's widths; `configs/hstu_ranking.py` and
    `configs/hstu_retrieval.py` hold the registered ones. A ranking
    configuration has a task MLP ending in one logit; a retrieval one has
    none (`task_mlp` empty) and a `retrieve_k`."""

    d_model: int
    heads: int
    d_qk: int
    d_v: int
    layers: int
    max_seq_len: int               # N: history tokens and candidates
    time_buckets: int              # w has time_buckets + 1 entries
    task_mlp: tuple[int, ...]
    item_rows: int
    action_rows: int
    table_dtype: str
    eps: float                     # both LayerNorms
    retrieve_k: int = 0            # item rows a user retrieves; 0: ranking

    def __post_init__(self):
        if self.task_mlp and self.task_mlp[-1] != 1:
            raise ValueError("the task MLP ends in one logit")
        if bool(self.task_mlp) == bool(self.retrieve_k):
            raise ValueError("a task MLP (ranking) or a retrieve_k "
                             "(retrieval), one of them")

    @property
    def uvqk_width(self) -> int:
        return self.heads * (2 * self.d_v + 2 * self.d_qk)

    def stage(self) -> RaggedStageConfig:
        """The embedding stage: the item and the action table, one row a
        bag each."""
        return RaggedStageConfig(
            dim=self.d_model, dtype=self.table_dtype, combine="sum",
            storage="device", table_rows=(self.item_rows, self.action_rows),
            table_pooling=(1, 1))


@dataclasses.dataclass(frozen=True)
class JaggedBatch:
    """A batch of users' engagements and candidates.

    `events` and `candidates` are the counts a user, on the host; the
    tensors lie on the model's device. Ids and times list every user's
    engagements in user order, then every user's candidates in user order.
    """

    events: tuple[int, ...]
    candidates: tuple[int, ...]
    event_offsets: torch.Tensor     # [U + 1] int32
    candidate_offsets: torch.Tensor  # [U + 1] int32
    item_ids: torch.Tensor          # [E + C] int32, in [0, item_rows)
    action_ids: torch.Tensor        # [E] int32, in [0, action_rows)
    timestamps: torch.Tensor        # [E + C] int64 seconds; a candidate's
    #                                 is its request's time

    @property
    def num_events(self) -> int:
        return sum(self.events)

    @property
    def num_candidates(self) -> int:
        return sum(self.candidates)

    def layout(self) -> JaggedLayout:
        """The token rows: two tokens an engagement, one a candidate."""
        return JaggedLayout(tuple(2 * e for e in self.events),
                            tuple(self.candidates),
                            2 * self.event_offsets, self.candidate_offsets)


class HSTULayer(nn.Module):
    """One HSTU layer: parameters w_uvqk [d, h(2 d_v + 2 d_qk)], w_o
    [h d_v, d], b_o [d], pos_bias [2N - 1] and time_bias [B + 1]. Its
    forward takes the forward's time codes (`hstu_time_codes`)."""

    def __init__(self, cfg: HSTUConfig, *, generator, device):
        super().__init__()
        self.cfg = cfg
        meta = torch.device(device).type == "meta"

        def normal(shape, std):
            t = torch.empty(shape, dtype=torch.float32, device=device)
            if not meta:
                t.normal_(0.0, std, generator=generator)
            return nn.Parameter(t)

        self.w_uvqk = normal((cfg.d_model, cfg.uvqk_width), 0.02)
        w_o = torch.empty((cfg.heads * cfg.d_v, cfg.d_model), device=device)
        if not meta:
            nn.init.xavier_uniform_(w_o, generator=generator)
        self.w_o = nn.Parameter(w_o)
        self.b_o = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.pos_bias = normal((2 * cfg.max_seq_len - 1,), 0.02)
        self.time_bias = normal((cfg.time_buckets + 1,), 0.02)

    def forward(self, x: torch.Tensor, layout: JaggedLayout, codes):
        cfg = self.cfg
        hv, hqk = cfg.heads * cfg.d_v, cfg.heads * cfg.d_qk
        with span("hstu.uvqk"):
            h = F.layer_norm(x, (cfg.d_model,), eps=cfg.eps)
            uvqk = F.silu(h @ self.w_uvqk, inplace=True)
        u, v, q, k = torch.split(uvqk, [hv, hv, hqk, hqk], dim=1)
        attn = hstu_attention(q, k, v, layout, codes, self.pos_bias,
                              self.time_bias, heads=cfg.heads,
                              max_seq_len=cfg.max_seq_len)
        with span("hstu.output"):
            y = F.layer_norm(attn, (hv,), eps=cfg.eps) * u
            return torch.addmm(self.b_o, y, self.w_o).add_(x)


class HSTUEncoder(nn.Module):
    """The stack of `HSTULayer`s over a jagged batch's token rows: x [rows,
    d] -> the last layer's states [rows, d]. The pairs' time codes are
    built once, before the first layer, and every layer reads them."""

    def __init__(self, cfg: HSTUConfig, *, generator, device):
        super().__init__()
        self.layers = nn.ModuleList(
            HSTULayer(cfg, generator=generator, device=device)
            for _ in range(cfg.layers))
        self.register_buffer("thresholds", torch.tensor(
            bucket_thresholds(cfg.time_buckets), dtype=torch.int64,
            device=device), persistent=False)

    def forward(self, x: torch.Tensor, layout: JaggedLayout,
                times: torch.Tensor) -> torch.Tensor:
        codes = hstu_time_codes(layout, times, self.thresholds)
        for layer in self.layers:
            x = layer(x, layout, codes)
        return x


class HSTU(nn.Module):
    """`HSTU(cfg, device=..., seed=...)` draws random weights on `device`;
    `tables=` hands the embedding stage existing tables ([item_rows +
    action_rows, d] in `table_dtype`: the items, then the actions).
    Submodules: `ebc`, `encoder` and `head` (the task MLP; None in a
    retrieval configuration, which calls `retrieve` in place of `forward`).

    Counters, as the kernels count their launches (set them to 0 to
    restart): `tokens` and `pairs`, the token rows and the (query, key)
    pairs a head that the mask lets in, summed over every forward and
    retrieval; `queries`, the users `retrieve` has scanned for."""

    def __init__(self, cfg: HSTUConfig, *, device="cuda", seed: int = 0,
                 tables: torch.Tensor | None = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        self.ebc = EmbeddingBagCollection(cfg.stage(), device=device,
                                          generator=gen, tables=tables)
        self.encoder = HSTUEncoder(cfg, generator=gen, device=device)
        self.head = (MLPTower((cfg.d_model, *cfg.task_mlp), torch.float32,
                              generator=gen, device=device)
                     if cfg.task_mlp else None)
        self.tokens = 0
        self.pairs = 0
        self.queries = 0

    def embed(self, batch: JaggedBatch) -> torch.Tensor:
        """The token rows [2E + C, d] float32: each engagement's item and
        action rows side by side, then each candidate's item row."""
        events = batch.num_events
        ids = torch.zeros((events + batch.num_candidates, 2),
                          dtype=torch.int32, device=batch.item_ids.device)
        ids[:, 0] = batch.item_ids
        ids[:events, 1] = batch.action_ids
        rows = self.ebc(ids)                       # [E + C, 2, d]
        return torch.cat([rows[:events].reshape(2 * events, -1),
                          rows[events:, 0]])

    def forward(self, batch: JaggedBatch) -> torch.Tensor:
        """-> one logit a candidate [C], in the batch's candidate order."""
        if self.head is None:
            raise ValueError("a retrieval configuration has no task MLP: "
                             "call HSTU.retrieve")
        with span("hstu.forward"):
            layout = batch.layout()
            self.tokens += layout.rows
            self.pairs += layout.pairs()
            x = self.embed(batch)
            events = batch.num_events
            ts = batch.timestamps
            times = torch.cat([ts[:events].repeat_interleave(2),
                               ts[events:]])
            states = self.encoder(x, layout, times)
            with span("hstu.head"):
                return self.head(states[layout.hist_total:])[:, 0]

    def retrieve(self, batch: JaggedBatch):
        """The k = `cfg.retrieve_k` best item rows a user for a batch of
        histories alone (every candidate count 0):

            H = encoder(the users' interleaved item and action tokens)
            q = H[last action token] / ||H[last action token]||_2
            ids, scores = the k rows j of largest q . item_rows[j]

        -> (ids [U, k] int32, scores [U, k] float32, best first, ties to
        the smaller row; queries [U, d] float32), under the span
        `hstu.retrieve`. The item rows are the embedding stage's table
        [0, item_rows), read in place."""
        if any(batch.candidates):
            raise ValueError("retrieval takes histories alone: every "
                             "candidate count must be 0")
        if min(batch.events, default=0) < 1:
            raise ValueError("every user needs an engagement: its last "
                             "action token is the query")
        with span("hstu.retrieve"):
            layout = batch.layout()
            self.tokens += layout.rows
            self.pairs += layout.pairs()
            self.queries += layout.users
            states = self.encoder(self.embed(batch), layout,
                                  batch.timestamps.repeat_interleave(2))
            with span("hstu.query"):
                last = states[2 * batch.event_offsets[1:].long() - 1]
                queries = last / torch.linalg.vector_norm(last, dim=1,
                                                          keepdim=True)
            ids, scores = mips_topk(
                queries, self.ebc.tables[:self.cfg.item_rows],
                self.cfg.retrieve_k)
            return ids, scores, queries
