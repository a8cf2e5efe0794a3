"""The HSTU generative-retrieval cell (Zhai et al., arXiv:2402.17152, §2.1):
each user's history of interleaved item and action tokens through
hstu-ranking's encoder, the last action token's state, L2-normalised, as
the query, and the K best of every item row by dot product. Inputs from the
seed, the program under test, its reference, and the work a batch needs.

The tables, the weights and the pool batches are `bench/models/hstu.py`'s,
drawn by its `make_inputs` with one candidate a user, which is then
dropped: every batch holds histories alone. The program is
`repro_torch.models.hstu.HSTU` built for retrieval (no task MLP) on the
benchmark's tables (adopted, not copied) and weights; the timed call is
`HSTU.retrieve(batch)`, which returns each user's K row ids, scores and
query. The step then rescores each returned id itself, `queries[u] .
table[id]` widened to float32, and hands back those U x K numbers, user
by user, best first: set against the reference's sorted scores, they
check the query, the ids and their order, and rows whose scores nearly tie
cannot fail them.
"""
from __future__ import annotations

import torch

from bench.harness import spec
from bench.reference import hstu_retrieval as reference

hstu = spec.load_module("models", "hstu")


def _require_retrieval_program() -> None:
    """Fail at once, before 51 GB of rows are drawn, on a program whose
    HSTU has no retrieval entry."""
    try:
        from repro_torch.models.hstu import HSTU
    except ImportError:
        HSTU = None
    if not hasattr(HSTU, "retrieve"):
        raise RuntimeError("the program has no HSTU.retrieve: it cannot "
                           "retrieve")


def histories_alone(b) -> "hstu.Batch":
    """A pool batch of `hstu.make_inputs` with its candidates dropped."""
    events = sum(b.events)
    users = len(b.events)
    return hstu.Batch(
        events=b.events, candidates=(0,) * users,
        event_offsets=b.event_offsets,
        candidate_offsets=torch.zeros(users + 1, dtype=torch.int32,
                                      device=b.event_offsets.device),
        item_ids=b.item_ids[:events].contiguous(),
        action_ids=b.action_ids,
        timestamps=b.timestamps[:events].contiguous())


def make_inputs(cfg: dict, traffic: dict, seed: int,
                device: torch.device):
    """`hstu.make_inputs` with one candidate a user (its arange takes no
    step of 0), then each pool batch's candidates dropped; no task MLP."""
    _require_retrieval_program()
    users, k = traffic["users"], cfg["retrieve_k"]
    if users * k != traffic["batch"]:
        raise ValueError(f"batch {traffic['batch']} is not {users} users x "
                         f"{k} retrieved")
    if cfg["task_mlp"]:
        raise ValueError("a retrieval configuration has no task MLP")
    inputs = hstu.make_inputs(cfg, {**traffic, "candidates": 1,
                                    "batch": users}, seed, device)
    inputs.pool = [(histories_alone(b), None) for b, _ in inputs.pool]
    return inputs


def build_program(cfg: dict, inputs, device: torch.device):
    """`HSTU` for retrieval on the benchmark's tables, with its weights
    loaded through the state dict."""
    from repro_torch.models.hstu import HSTU, HSTUConfig

    model_cfg = HSTUConfig(
        d_model=cfg["d_model"], heads=cfg["heads"], d_qk=cfg["d_qk"],
        d_v=cfg["d_v"], layers=cfg["layers"],
        max_seq_len=cfg["max_seq_len"], time_buckets=cfg["time_buckets"],
        task_mlp=(), item_rows=cfg["item_rows"],
        action_rows=cfg["action_rows"], table_dtype=cfg["table_dtype"],
        eps=cfg["eps"], retrieve_k=cfg["retrieve_k"])
    model = HSTU(model_cfg, device=device, tables=inputs.tables)
    state = {}
    for i, layer in enumerate(inputs.layers):
        state.update({f"encoder.layers.{i}.{k}": v for k, v in layer.items()})
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or set(missing) != {"ebc.tables"}:
        raise RuntimeError(f"state dict: missing {missing}, "
                           f"unexpected {unexpected}")
    return model.eval()


def step(model, batch, _unused) -> torch.Tensor:
    """The timed call: `HSTU.retrieve`, then each returned id rescored by
    the benchmark against its user's returned query -> [U K] float32, user
    by user, best first."""
    from repro_torch.models.hstu import JaggedBatch
    ids, _, queries = model.retrieve(JaggedBatch(**vars(batch)))
    rows = model.ebc.tables[ids.long()].float()          # [U, K, d]
    return torch.bmm(rows, queries[:, :, None]).reshape(-1)


def layers(model) -> dict:
    """Modules whose calls the traced run marks as ranges."""
    return {"ebc": model.ebc, "encoder": model.encoder}


def checked_module(model):
    """The module whose output the check compares beside the scores: the
    encoder's last-layer states of every history token [2E, d] float32."""
    return model.encoder


def reference_outputs(cfg: dict, inputs, k: int, lower: bool = False):
    """(states [2E, d], scores [U K]) of pool batch `k` by the plain
    reference, or by the control with `lower`."""
    b = inputs.pool[k][0]
    states, _, scores = reference.retrieve(
        inputs.tables, inputs.layers, cfg, b.events, b.item_ids,
        b.action_ids, b.timestamps, lower=lower)
    return states, scores.reshape(-1)


def work(cfg: dict, inputs, k: int) -> dict:
    """What pool batch `k` needs at least, whatever implements it.

    attn_flops: the attention's two products over the pairs the mask lets
    in (each history causally), 2 h (d_qk + d_v) a pair, summed over the
    layers.
    mips_flops: every item row against every query, 2 d a pair.
    step_flops: `attn_flops`, the products to U, V, Q, K (2 d h(2 d_v +
    2 d_qk) a token and layer) and by W_o (2 h d_v d), and `mips_flops`.
    mips_bytes: each item row read once, the queries (float32) read once,
    and each retrieved id (int32) and score (float32) written once.
    step_bytes: each item row once (the embedding stage's are among them),
    each distinct action row once, each id (int32) and timestamp (int64)
    once, every weight once (float32), and the queries, ids and scores
    written once.
    """
    b = inputs.pool[k][0]
    d, h, dqk, dv = cfg["d_model"], cfg["heads"], cfg["d_qk"], cfg["d_v"]
    users, num_e, top = len(b.events), sum(b.events), cfg["retrieve_k"]
    tokens = 2 * num_e
    pairs = hstu.masked_in_pairs(b.events, b.candidates)
    n_layers = cfg["layers"]
    attn_flops = n_layers * 2 * h * (dqk + dv) * pairs
    width = h * (2 * dv + 2 * dqk)
    product_flops = n_layers * tokens * 2 * (d * width + h * dv * d)
    mips_flops = 2 * users * cfg["item_rows"] * d
    row_bytes = d * getattr(torch, cfg["table_dtype"]).itemsize
    action_rows = int(torch.unique(b.action_ids).numel())
    params = n_layers * (d * width + h * dv * d + d
                         + 2 * cfg["max_seq_len"] - 1
                         + cfg["time_buckets"] + 1)
    outputs = users * d * 4 + users * top * 8
    return {
        "tokens": tokens,
        "masked_in_pairs": pairs,
        "attn_flops": attn_flops,
        "mips_flops": mips_flops,
        "step_flops": attn_flops + product_flops + mips_flops,
        "mips_bytes": cfg["item_rows"] * row_bytes + outputs,
        "step_bytes": (cfg["item_rows"] + action_rows) * row_bytes
        + 2 * num_e * 4 + num_e * 8 + params * 4 + outputs,
    }
