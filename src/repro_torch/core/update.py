"""Shared bookkeeping for online model-update transactions.

Every updatable storage backend (`device`, `tiered`'s parameter server,
`sharded`, `pool`, tenant views) speaks the same four verbs —
`begin_update(version)` / `apply_update(table, rows, values)` /
`commit_update(version)` / `abort_update(version)` — and they all need
identical transaction plumbing: version monotonicity, one open
transaction at a time, per-table row buffering with last-write-wins
merge, and geometry/dtype validation against the backend's table shape.
`UpdateTxn` is that plumbing, factored here (the neutral bottom layer)
so the storage backends and the parameter server can all import it
without a cycle.

Values may be numpy arrays or tensors on any device. A bfloat16 table's
rows are buffered as their 16-bit patterns (`utils.host_array`), so the
transaction and its merge never round a value.

The buffered rows are INVISIBLE to lookups by construction — the
backend only touches its tiers at commit, from the single serving
thread, so a lookup racing an apply serves the old version bit-exact.
"""
from __future__ import annotations

import numpy as np

from repro_torch.utils import dtype_name, host_array, host_dtype


class UpdateTxn:
    """One open update transaction: buffered changed rows per table.

    `add()` validates each chunk against the table geometry the moment
    it arrives (a bad apply fails BEFORE any tier is touched — that is
    what makes backend commits all-or-none); `merged()` folds repeated
    applies to the same row down to the last write.
    """

    def __init__(self, version: int, committed: int):
        version = int(version)
        if version <= committed:
            raise ValueError(
                f"update versions are monotonic: cannot open v{version} "
                f"over committed v{committed}")
        self.version = version
        self._chunks: dict[int, list] = {}
        self.rows = 0

    def add(self, table: int, rows: np.ndarray, values: np.ndarray, *,
            num_tables: int, num_rows: int, dim: int, dtype) -> None:
        table = int(table)
        rows = np.asarray(rows, np.int64).ravel()
        values, _ = host_array(values)
        if not 0 <= table < num_tables:
            raise ValueError(f"update v{self.version}: table {table} "
                             f"outside [0, {num_tables})")
        if rows.size and (rows.min() < 0 or rows.max() >= num_rows):
            raise ValueError(f"update v{self.version}: table {table} rows "
                             f"outside [0, {num_rows})")
        if values.shape != (rows.size, dim):
            raise ValueError(
                f"update v{self.version}: table {table} values shape "
                f"{list(values.shape)} != [{rows.size}, {dim}]")
        if values.dtype != host_dtype(dtype):
            raise ValueError(
                f"update v{self.version}: table {table} dtype "
                f"{values.dtype} != table dtype {dtype_name(dtype)} — "
                f"updates must preserve the table dtype bit-exactly")
        if rows.size == 0:
            return                       # empty delta for this table: legal
        self._chunks.setdefault(table, []).append((rows, values))
        self.rows += int(rows.size)

    def check_commit(self, version: int) -> None:
        if int(version) != self.version:
            raise ValueError(
                f"commit_update({int(version)}) does not match the open "
                f"transaction v{self.version}")

    def merged(self) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """table -> (rows [n] sorted unique, values [n, D]); when the same
        row was applied twice, the LAST applied payload wins."""
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for t, chunks in self._chunks.items():
            rows = np.concatenate([r for r, _ in chunks])
            vals = np.concatenate([v for _, v in chunks])
            # np.unique on the reversed array: first occurrence there is
            # the last write in apply order
            u, idx = np.unique(rows[::-1], return_index=True)
            keep = rows.size - 1 - idx
            out[t] = (u, vals[keep])
        return out


def require_open(txn, verb: str) -> UpdateTxn:
    """The standard 'no transaction open' error every backend raises."""
    if txn is None:
        raise RuntimeError(
            f"{verb}: no update transaction open — begin_update(version) "
            f"first")
    return txn
