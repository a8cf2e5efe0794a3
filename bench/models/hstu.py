"""The HSTU generative-ranking cell (Zhai et al., arXiv:2402.17152, §3):
jagged user histories of interleaved item and action tokens, 8 layers of
pointwise SiLU attention with a relative time and position bias, and each
user's candidates scored in one target-aware pass. Inputs from the seed,
the program under test, its reference, and the work a batch needs.

The program is `repro_torch.models.hstu.HSTU` on the benchmark's tables
(items, then actions: [item_rows + action_rows, d] bf16, adopted, not
copied) and weights. The timed call is `HSTU.forward(batch)` on a
`JaggedBatch`: the users' event and candidate counts (host), their offsets,
the item ids of every engagement then every candidate, the action ids of
every engagement, and the timestamps of each. Its logits, one a candidate,
are the batch's queries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math

import torch

from bench.harness import hotness
from bench.reference import hstu as reference

TABLE_CHUNK_ROWS = 1 << 23  # rows drawn by one call
START_S = 1_700_000_000     # the users' first engagement, seconds


@dataclasses.dataclass
class Batch:
    """One batch as the program takes it (the fields of `JaggedBatch`)."""

    events: tuple
    candidates: tuple
    event_offsets: torch.Tensor      # [U + 1] int32
    candidate_offsets: torch.Tensor  # [U + 1] int32
    item_ids: torch.Tensor           # [E + C] int32
    action_ids: torch.Tensor         # [E] int32
    timestamps: torch.Tensor         # [E + C] int64


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""

    tables: torch.Tensor             # [item_rows + action_rows, d]
    layers: list                     # [{w_uvqk, w_o, b_o, pos_bias, time_bias}]
    head: list                       # [(w [in, out], b [out])]
    pool: list                       # [(Batch, None)]


def history_lengths(traffic: dict) -> list:
    """Engagements of the batch's users: log-uniform from the shortest to
    the longest history, end to end."""
    users = traffic["users"]
    lo, hi = traffic["history_min_events"], traffic["history_max_events"]
    return [round(lo * (hi / lo) ** (k / (users - 1))) for k in range(users)]


def _require_hstu_program() -> None:
    """Fail at once, before 51 GB of rows are drawn, on a program that
    has no HSTU."""
    if importlib.util.find_spec("repro_torch.models.hstu") is None:
        raise RuntimeError("the program has no repro_torch.models.hstu: it "
                           "cannot run HSTU")


def make_inputs(cfg: dict, traffic: dict, seed: int,
                device: torch.device) -> Inputs:
    """The pool of batches, the weights and the tables, drawn on `device`
    from one generator seeded with `seed`, in that order. Every pool batch
    has the same users' lengths, in an order the seed permutes; item ids
    follow the traffic's Zipf over the item rows (one rank -> row
    permutation), action ids are uniform, and the gaps between a user's
    engagements are exponential; the candidates share the request's time,
    one more gap after the last engagement."""
    _require_hstu_program()
    users, cands = traffic["users"], traffic["candidates"]
    if users * cands != traffic["batch"]:
        raise ValueError(f"batch {traffic['batch']} is not {users} users x "
                         f"{cands} candidates")
    gen = torch.Generator(device=device).manual_seed(seed)
    lengths = history_lengths(traffic)
    sampler = hotness.HotnessSampler(tables=1, rows=cfg["item_rows"],
                                     alpha=traffic["zipf_alpha"],
                                     generator=gen)
    pool = []
    for _ in range(traffic["pool_batches"]):
        order = torch.randperm(users, generator=gen, device=device).tolist()
        events = tuple(lengths[i] for i in order)
        num_e, num_c = sum(events), users * cands
        items = sampler.sample(num_e + num_c, 1).reshape(-1)
        actions = torch.randint(0, cfg["action_rows"], (num_e,),
                                generator=gen, device=device,
                                dtype=torch.int32)
        gaps = torch.empty(num_e + users, device=device,
                           dtype=torch.float64).exponential_(
            1.0 / traffic["gap_mean_s"], generator=gen)
        ev_t, cand_t, at = [], [], 0
        for e in events:
            t = START_S + gaps[at:at + e + 1].cumsum(0).long()
            ev_t.append(t[:e])
            cand_t.append(t[e:].expand(cands))
            at += e + 1
        offsets = [0]
        for e in events:
            offsets.append(offsets[-1] + e)
        pool.append((Batch(
            events=events, candidates=(cands,) * users,
            event_offsets=torch.tensor(offsets, dtype=torch.int32,
                                       device=device),
            candidate_offsets=torch.arange(0, num_c + 1, cands,
                                           dtype=torch.int32, device=device),
            item_ids=items.contiguous(), action_ids=actions,
            timestamps=torch.cat(ev_t + cand_t).contiguous()), None))
    del sampler

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def fan_in(fan_in, fan_out):
        w = torch.empty((fan_in, fan_out), device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(1.0 / math.sqrt(fan_in))

    d, h = cfg["d_model"], cfg["heads"]
    width = h * (2 * cfg["d_v"] + 2 * cfg["d_qk"])
    layers = [{"w_uvqk": normal((d, width), 0.02),
               "w_o": fan_in(h * cfg["d_v"], d),
               "b_o": normal((d,), 0.05),
               "pos_bias": normal((2 * cfg["max_seq_len"] - 1,), 0.02),
               "time_bias": normal((cfg["time_buckets"] + 1,), 0.02)}
              for _ in range(cfg["layers"])]
    dims = [d, *cfg["task_mlp"]]
    head = [(fan_in(i, o), normal((o,), 0.05))
            for i, o in zip(dims[:-1], dims[1:])]
    tables = torch.empty((cfg["item_rows"] + cfg["action_rows"], d),
                         dtype=getattr(torch, cfg["table_dtype"]),
                         device=device)
    for r0 in range(0, tables.shape[0], TABLE_CHUNK_ROWS):
        chunk = tables[r0:r0 + TABLE_CHUNK_ROWS]
        torch.randn(chunk.shape, generator=gen, device=device,
                    dtype=chunk.dtype, out=chunk)
        chunk.mul_(1.0 / math.sqrt(d))
    return Inputs(tables=tables, layers=layers, head=head, pool=pool)


def build_program(cfg: dict, inputs: Inputs, device: torch.device):
    """`HSTU` on the benchmark's tables, with its weights loaded through
    the state dict."""
    from repro_torch.models.hstu import HSTU, HSTUConfig

    model_cfg = HSTUConfig(
        d_model=cfg["d_model"], heads=cfg["heads"], d_qk=cfg["d_qk"],
        d_v=cfg["d_v"], layers=cfg["layers"],
        max_seq_len=cfg["max_seq_len"], time_buckets=cfg["time_buckets"],
        task_mlp=tuple(cfg["task_mlp"]), item_rows=cfg["item_rows"],
        action_rows=cfg["action_rows"], table_dtype=cfg["table_dtype"],
        eps=cfg["eps"])
    model = HSTU(model_cfg, device=device, tables=inputs.tables)
    state = {}
    for i, layer in enumerate(inputs.layers):
        state.update({f"encoder.layers.{i}.{k}": v for k, v in layer.items()})
    for i, (w, b) in enumerate(inputs.head):
        state[f"head.w{i}"], state[f"head.b{i}"] = w, b
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or set(missing) != {"ebc.tables"}:
        raise RuntimeError(f"state dict: missing {missing}, "
                           f"unexpected {unexpected}")
    return model.eval()


def step(model, batch: Batch, _unused) -> torch.Tensor:
    """The timed call: logits [C] of one batch (the driver hands each pool
    entry's two parts; the second is unused)."""
    from repro_torch.models.hstu import JaggedBatch
    return model(JaggedBatch(**vars(batch)))


def layers(model) -> dict:
    """Modules whose calls the traced run marks as ranges."""
    return {"ebc": model.ebc, "encoder": model.encoder, "head": model.head}


def checked_module(model):
    """The module whose output the check compares beside the logits: the
    encoder's last-layer states of every token [2E + C, d] float32. (A
    gather of bf16 rows in bags of one cannot round, so the embedding
    stage's output would not tell the control from the program.)"""
    return model.encoder


def reference_outputs(cfg: dict, inputs: Inputs, k: int,
                      lower: bool = False):
    """(states [2E + C, d], logits [C]) of pool batch `k` by the plain
    reference, or by the control with `lower`."""
    b = inputs.pool[k][0]
    return reference.forward(inputs.tables, inputs.layers, inputs.head, cfg,
                             b.events, b.candidates, b.item_ids,
                             b.action_ids, b.timestamps, lower=lower)


def masked_in_pairs(events, candidates) -> int:
    """(query, key) pairs a head and layer that the mask lets in: n_h (n_h
    + 1) / 2 in each history of n_h = 2e tokens, n_h + 1 for each
    candidate."""
    return sum(2 * e * (2 * e + 1) // 2 + m * (2 * e + 1)
               for e, m in zip(events, candidates))


def work(cfg: dict, inputs: Inputs, k: int) -> dict:
    """What pool batch `k` needs at least, whatever implements it.

    attn_flops: the attention's two products over the pairs the mask lets
    in, 2 h (d_qk + d_v) a pair, summed over the layers.
    step_flops: `attn_flops`, the products to U, V, Q, K (2 d h(2 d_v +
    2 d_qk) a token and layer) and by W_o (2 h d_v d), and the task MLP
    (2 in out a candidate and layer).
    bag_bytes: the embedding stage reads each distinct item and action row
    once and each id (int32) once, and writes each token's row once in
    float32 (an engagement's item and action, a candidate's item).
    step_bytes: each distinct item and action row read once, each id (int32)
    and timestamp (int64) once, every weight once (float32), and the logits
    written once.
    """
    b = inputs.pool[k][0]
    d, h, dqk, dv = cfg["d_model"], cfg["heads"], cfg["d_qk"], cfg["d_v"]
    num_e, num_c = sum(b.events), sum(b.candidates)
    tokens = 2 * num_e + num_c
    pairs = masked_in_pairs(b.events, b.candidates)
    n_layers = cfg["layers"]
    attn_flops = n_layers * 2 * h * (dqk + dv) * pairs
    width = h * (2 * dv + 2 * dqk)
    product_flops = n_layers * tokens * 2 * (d * width + h * dv * d)
    dims = [d, *cfg["task_mlp"]]
    head_flops = num_c * sum(2 * i * o for i, o in zip(dims[:-1], dims[1:]))
    item_rows = int(torch.unique(b.item_ids).numel())
    action_rows = int(torch.unique(b.action_ids).numel())
    row_bytes = d * getattr(torch, cfg["table_dtype"]).itemsize
    params = (n_layers * (d * width + h * dv * d + d
                          + 2 * cfg["max_seq_len"] - 1
                          + cfg["time_buckets"] + 1)
              + sum(i * o + o for i, o in zip(dims[:-1], dims[1:])))
    return {
        "tokens": tokens,
        "masked_in_pairs": pairs,
        "distinct_rows": item_rows + action_rows,
        "attn_flops": attn_flops,
        "step_flops": attn_flops + product_flops + head_flops,
        "bag_bytes": (item_rows + action_rows) * row_bytes
        + (2 * num_e + num_c) * 4 + tokens * d * 4,
        "step_bytes": (item_rows + action_rows) * row_bytes
        + (2 * num_e + num_c) * 4 + (num_e + num_c) * 8 + params * 4
        + num_c * 4,
    }
