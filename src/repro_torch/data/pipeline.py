"""Deterministic, resumable synthetic data pipelines.

Two families:
  * DLRMQueryStream — dense + categorical features with per-table hotness
    (paper §V datasets; heterogeneous mixes per Table VII).
  * TokenStream — LM token batches (Zipf-distributed vocabulary, so the
    pinned-vocab gather path sees realistic skew).

Determinism contract: state is (seed, step). `state_dict()`/`load_state_dict`
round-trip exactly; a restored stream reproduces the same batches — this is
what checkpoint/restart tests assert.

A numpy-only copy of `repro/data/pipeline.py` over the port's own
`core/access_patterns.py`: on the same seed and step both packages make
the same batches, bit for bit. Batches stay numpy arrays on the host;
the train step moves them to the model's device. Bad arguments raise
`ValueError` where the reference asserts.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.access_patterns import make_pattern

# paper Table VII heterogeneous mixtures (counts per hotness level)
HETERO_MIXES = {
    "mix1": {"high_hot": 100, "med_hot": 75, "low_hot": 50, "random": 25},
    "mix2": {"high_hot": 62, "med_hot": 63, "low_hot": 63, "random": 62},
    "mix3": {"high_hot": 25, "med_hot": 50, "low_hot": 75, "random": 100},
}


@dataclasses.dataclass
class DLRMBatch:
    dense: np.ndarray      # [B, F] float32
    indices: np.ndarray    # [B, T, L] int32
    labels: np.ndarray     # [B] float32


class DLRMQueryStream:
    def __init__(self, *, num_tables: int, rows: int, pooling: int,
                 batch_size: int, dense_features: int = 13,
                 hotness: str | Sequence[str] = "med_hot", seed: int = 0):
        if isinstance(hotness, str):
            hotness = [hotness] * num_tables
        if len(hotness) != num_tables:
            raise ValueError(f"{len(hotness)} hotness levels for "
                             f"{num_tables} tables")
        self.patterns = [make_pattern(h, rows, seed=seed + t)
                         for t, h in enumerate(hotness)]
        self.num_tables = num_tables
        self.rows = rows
        self.batch_size = batch_size
        self.pooling = pooling
        self.dense_features = dense_features
        self.seed = seed
        self.step = 0

    @classmethod
    def heterogeneous(cls, mix: str, rows: int, pooling: int,
                      batch_size: int, seed: int = 0) -> "DLRMQueryStream":
        hotness = []
        for h, n in HETERO_MIXES[mix].items():
            hotness += [h] * n
        return cls(num_tables=len(hotness), rows=rows, pooling=pooling,
                   batch_size=batch_size, hotness=hotness, seed=seed)

    def next_batch(self) -> DLRMBatch:
        rng = np.random.default_rng((self.seed << 20) ^ self.step)
        b = self.batch_size
        idx = np.stack(
            [p.sample(b, self.pooling, seed=self.step * 1000 + t)
             for t, p in enumerate(self.patterns)], axis=1)
        batch = DLRMBatch(
            dense=rng.standard_normal((b, self.dense_features),
                                      dtype=np.float32),
            indices=idx.astype(np.int32),
            labels=(rng.random(b) < 0.2).astype(np.float32),
        )
        self.step += 1
        return batch

    def sample_trace(self, num_batches: int = 4,
                     peek: bool = False) -> np.ndarray:
        """The next `num_batches` batches' indices as one planning trace
        [num_batches * B, T, L] — offline profiling input for hot-tier
        planning (paper §IV-C) and the tiered parameter server's initial
        plans. By default the profiled batches are CONSUMED (they are the
        profiling window's traffic; serving continues on fresh batches —
        planning and evaluation windows must not coincide). `peek=True`
        restores the stream position instead."""
        step0 = self.step
        try:
            return np.concatenate(
                [self.next_batch().indices for _ in range(num_batches)],
                axis=0)
        finally:
            if peek:
                self.step = step0

    def __iter__(self) -> Iterator[DLRMBatch]:
        while True:
            yield self.next_batch()

    # -- resume -------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, st: dict) -> None:
        if st["seed"] != self.seed:
            raise ValueError(f"stream seed mismatch on restore: "
                             f"{st['seed']} != {self.seed}")
        self.step = int(st["step"])


class TokenStream:
    """Zipf-vocabulary LM batches, shard-aware for data parallelism."""

    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 zipf_alpha: float = 1.1, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        if global_batch % num_shards:
            raise ValueError(f"global_batch {global_batch} is not a "
                             f"multiple of num_shards {num_shards}")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // num_shards
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self.step = 0
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        w = ranks ** (-zipf_alpha)
        self._cdf = np.cumsum(w / w.sum())

    def next_batch(self) -> dict:
        rng = np.random.default_rng(
            (self.seed << 24) ^ (self.step * self.num_shards + self.shard))
        n = self.local_batch * (self.seq_len + 1)
        u = rng.random(n)
        toks = np.searchsorted(self._cdf, u).astype(np.int32).reshape(
            self.local_batch, self.seq_len + 1)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step, "shard": self.shard}

    def load_state_dict(self, st: dict) -> None:
        if st["seed"] != self.seed or st["shard"] != self.shard:
            raise ValueError(f"stream (seed, shard) mismatch on restore: "
                             f"({st['seed']}, {st['shard']}) != "
                             f"({self.seed}, {self.shard})")
        self.step = int(st["step"])
