"""Cold tier — full embedding tables in host memory.

Holds the authoritative copy of every table as one [T, R, D] numpy array
(raw row-id space; no hot-first permutation — remapping is a hot-tier
concern). Serves batched gathers for warm-tier misses and hands out whole
hot blocks at (re)planning time. Gather counters feed the host-traffic
accounting.

The tables are adopted, never copied: a contiguous array (or the numpy
view of a collection's host tensor) becomes the cold tier as it is, so at
the production size (64 GB) the host holds one copy.

Thread-safety: tables are immutable during serving, so concurrent reads
(the async prefetch worker gathering while the serving thread resolves a
residual miss) are race-free by construction; only the traffic counters
need the lock.

A port of `repro/ps/cold_store.py`. Where it differs: the squared row norms
are computed per table (the same values), so degraded mode never casts
every table to float64 at once; and a gather lands in a buffer of its own
mapping (`take_rows`), which goes back to the OS as soon as it is freed.
"""
from __future__ import annotations

import mmap
import threading

import numpy as np
import torch


# buffers from this size up get their own mapping
_MAPPED_MIN_BYTES = 1 << 20


def host_rows(n: int, dim: int, dtype) -> np.ndarray:
    """An uninitialised [n, dim] host array; from 1 MiB up it lives in a
    private anonymous mapping of its own, unmapped when the array is freed
    (a shared one, `mmap`'s default, is backed by shmem, whose page faults
    cost several times as much).

    The tiered path's per-table row buffers (staged payloads, cold
    gathers, admission payloads: 25-32 MB each at the production size) sit
    at glibc's largest mmap threshold, so malloc serves them from its
    heaps, and the prefetch worker's from an arena of its own. Freed there,
    they stay resident; beside a 64 GB cold tier that fragmentation decides
    whether the host holds a serving run."""
    dtype = np.dtype(dtype)
    nbytes = n * dim * dtype.itemsize
    if nbytes < _MAPPED_MIN_BYTES:
        return np.empty((n, dim), dtype)
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE)
    return np.frombuffer(buf, dtype).reshape(n, dim)


def take_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """src[idx] for a [R, D] host array and row ids [M], into `host_rows`
    (torch's host index_select: the same bytes as numpy's fancy indexing,
    gathered on every core)."""
    out = host_rows(len(idx), src.shape[1], src.dtype)
    torch.index_select(torch.from_numpy(src), 0,
                       torch.from_numpy(np.asarray(idx, np.int64)),
                       out=torch.from_numpy(out))
    return out


class ColdStore:
    def __init__(self, tables: np.ndarray):
        tables = np.ascontiguousarray(tables)
        assert tables.ndim == 3, "expected stacked tables [T, R, D]"
        self.tables = tables
        self.num_tables, self.num_rows, self.dim = tables.shape
        self.gathered_rows = 0      # rows pulled host->device (proxy)
        self.gather_calls = 0
        # per table [R] float64, NaN until a row's norm is first asked for
        self._norms_sq: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()   # counters only; tables are read-only

    @property
    def nbytes(self) -> int:
        return self.tables.nbytes

    def gather(self, table: int, rows: np.ndarray) -> np.ndarray:
        """Batched miss resolution: rows [M] -> [M, D] (one host gather).

        Safe to call from any thread; the payload is a copy
        (`take_rows`), so callers own the returned buffer outright.
        """
        with self._lock:
            self.gather_calls += 1
            self.gathered_rows += int(rows.size)
        return take_rows(self.tables[table], rows)

    def reset_counters(self) -> None:
        with self._lock:
            self.gathered_rows = 0
            self.gather_calls = 0

    def row_norms_sq(self, table: int, rows=None) -> np.ndarray:
        """Squared L2 norms (float64) of `rows` of one table, or of every
        row when `rows` is None.

        Each row's norm is computed the first time it is asked for and
        cached (rows change only through `update_rows`). Lets
        degraded-mode serving report the EXACT L2 error of zero-filling a
        row — ||row||² — reading only the rows it zero-fills: computing a
        whole table on first use would stall the first degraded batch for
        a scan of every table (64 GB at the production size)."""
        with self._lock:
            norms = self._norms_sq.get(table)
            if norms is None:
                norms = np.full(self.num_rows, np.nan)
                self._norms_sq[table] = norms
            if rows is None:
                rows = np.arange(self.num_rows)
            rows = np.asarray(rows, np.int64)
            missing = np.unique(rows[np.isnan(norms[rows])])
            if missing.size:
                r64 = self.tables[table][missing].astype(np.float64)
                norms[missing] = np.einsum("rd,rd->r", r64, r64)
            return norms[rows]

    def update_rows(self, table: int, rows: np.ndarray,
                    values: np.ndarray) -> None:
        """Online model update: overwrite `rows` of one table.

        The 'immutable during serving' contract above still holds where
        it matters: this runs on the single serving thread at update
        COMMIT, after the prefetch queue is flushed, so no concurrent
        gather can observe a torn row. Forgets the cached norms of the
        rows it writes — degraded-mode L2 accounting must see the new
        bytes.

        Copy-on-first-write: construction may have adopted a read-only
        view; the first committed update privatizes it."""
        if not self.tables.flags.writeable:
            self.tables = self.tables.copy()
        self.tables[table, rows] = values
        norms = self._norms_sq.get(table)
        if norms is not None:
            norms[rows] = np.nan

    def drop_norm_cache(self) -> None:
        """Invalidate the lazy norm cache after the table bytes changed
        underneath this store."""
        self._norms_sq.clear()

    def hot_block(self, table: int, hot_row_ids: np.ndarray) -> np.ndarray:
        """Materialize the device-resident hot block for one table."""
        return self.tables[table, hot_row_ids].copy()

    def row(self, table: int, row: int) -> np.ndarray:
        return self.tables[table, row]
