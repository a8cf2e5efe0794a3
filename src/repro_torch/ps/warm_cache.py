"""Warm tier — fixed-capacity per-table row cache with LFU/LRU eviction.

Slot-array layout mirrors a device-side cache: `data [C, D]` is the cached
row payload (the device allocation analogue), `slot_row / slot_freq /
slot_tick` are the tag store. Admission is miss-driven and batched: the
server resolves a lookup's distinct missing rows against the cold store in
one gather and admits them together, evicting the coldest victims
(lowest-frequency for LFU, least-recent for LRU; ties broken by older tick
then slot id — fully deterministic).

Two payload backings share the tag store and every policy decision:

  `WarmCache`       — host numpy payload.
  `DeviceWarmCache` — payload is a tensor on a torch device (the card in
                      serving), normally the table's view `payload[t]` of
                      one [T, C, D] tensor the parameter server owns.
                      Admission writes slots with `index_copy_`, reads
                      gather with `index_select`; the tag store stays on
                      the host so `probe()` never touches the device.
                      float32 rows survive the host->device->host round
                      trip bit-exactly, so lookups remain bit-identical to
                      a dense gather.

Counters are access-granular with standard cache semantics: a row resident
at batch start counts every access as a hit; a missed row counts ONE miss
(the fetch that brings it in) and its remaining same-batch accesses as hits
— intra-batch reuse is served from the just-fetched payload, exactly like a
hardware cache line filled on first touch.

A port of `repro/ps/warm_cache.py`: `WarmCache` is the reference's, line
for line; only `DeviceWarmCache`'s payload moves to torch. Its per-cache
fused verbs (`build_slot_map`, `lookup_fused`) serve one table; the
parameter server builds every table's slot map at once instead
(`ParameterServer.build_slot_map`).
"""
from __future__ import annotations

import numpy as np
import torch


class WarmCache:
    """One table's warm cache (host-backed payload)."""

    # fused kernel lookups need the payload device-resident; the host
    # backing answers False and callers fall back to probe()/read()
    supports_fused = False

    def __init__(self, capacity: int, dim: int, policy: str = "lfu",
                 dtype=np.float32):
        assert policy in ("lfu", "lru")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.policy = policy
        self.dtype = np.dtype(dtype)
        self._alloc_payload()
        self.slot_row = np.full(self.capacity, -1, np.int64)
        self.slot_freq = np.zeros(self.capacity, np.int64)
        self.slot_tick = np.zeros(self.capacity, np.int64)
        self.loc: dict[int, int] = {}      # row id -> slot
        self.tick = 0
        # access-granular counters
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.insertions = 0

    # -- payload backing (overridden by DeviceWarmCache) --------------------
    def _alloc_payload(self) -> None:
        self.data = np.zeros((self.capacity, self.dim), self.dtype)

    def _read_payload(self, slots: np.ndarray) -> np.ndarray:
        """slots [M] -> rows [M, D] as host numpy."""
        return self.data[slots]

    def _write_payload(self, slots: np.ndarray,
                       payload: np.ndarray) -> None:
        """Store rows [M, D] into (possibly scattered) slots [M]."""
        self.data[slots] = payload

    # -- tag store / policy --------------------------------------------------
    def __len__(self) -> int:
        return len(self.loc)

    def probe(self, rows: np.ndarray) -> np.ndarray:
        """rows [M] (distinct) -> slot per row, -1 where absent.

        Pure tag-store read: never touches the payload backing, mutates no
        state — safe to call speculatively (the prefetch stage probe).
        """
        return np.fromiter((self.loc.get(int(r), -1) for r in rows),
                           dtype=np.int64, count=len(rows))

    def read(self, slots: np.ndarray) -> np.ndarray:
        return self._read_payload(slots)

    def touch(self, slots: np.ndarray, counts: np.ndarray) -> None:
        """Register `counts[i]` accesses to resident slot `slots[i]`."""
        self.tick += 1
        self.slot_freq[slots] += counts
        self.slot_tick[slots] = self.tick
        self.hits += int(counts.sum())

    def admit(self, rows: np.ndarray, payload: np.ndarray,
              counts: np.ndarray) -> int:
        """Insert distinct missed rows (evicting victims as needed).

        Returns the number of evictions. When more rows arrive than the
        cache holds, only the first `capacity` are admitted (the rest stay
        cold-only — still correct, just uncached).
        """
        # one miss per distinct fetched row; its remaining accesses in this
        # batch are reuse of the fetched payload (hits)
        self.misses += len(rows)
        self.hits += int(counts.sum()) - len(rows)
        if self.capacity == 0 or len(rows) == 0:
            return 0
        self.tick += 1
        n = min(len(rows), self.capacity)
        rows, payload, counts = rows[:n], payload[:n], counts[:n]

        free = np.flatnonzero(self.slot_row < 0)
        n_evict = max(0, n - len(free))
        if n_evict:
            occupied = np.flatnonzero(self.slot_row >= 0)
            if self.policy == "lfu":
                order = np.lexsort((occupied, self.slot_tick[occupied],
                                    self.slot_freq[occupied]))
            else:  # lru
                order = np.lexsort((occupied, self.slot_tick[occupied]))
            victims = occupied[order[:n_evict]]
            for s in victims:
                del self.loc[int(self.slot_row[s])]
            self.evictions += n_evict
            slots = np.concatenate([free, victims])[:n]
        else:
            slots = free[:n]

        self._write_payload(slots, payload)
        self.slot_row[slots] = rows
        self.slot_freq[slots] = counts
        self.slot_tick[slots] = self.tick
        for r, s in zip(rows, slots):
            self.loc[int(r)] = int(s)
        self.insertions += n
        return n_evict

    def invalidate(self, rows: np.ndarray) -> int:
        """Drop entries (e.g. rows promoted to the hot tier at refresh).

        Tag-store only: the stale payload stays in its slot but is
        unreachable (no `loc` entry), matching a hardware invalidate.
        """
        dropped = 0
        for r in rows:
            s = self.loc.pop(int(r), None)
            if s is not None:
                self.slot_row[s] = -1
                self.slot_freq[s] = 0
                self.slot_tick[s] = 0
                dropped += 1
        return dropped

    def clear(self) -> None:
        """Drop every entry (counters untouched)."""
        self.slot_row.fill(-1)
        self.slot_freq.fill(0)
        self.slot_tick.fill(0)
        self.loc.clear()

    def decay(self, factor: float) -> None:
        """LFU aging so a stale hot burst cannot pin slots forever."""
        self.slot_freq = (self.slot_freq * factor).astype(np.int64)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "insertions": self.insertions,
                "occupancy": len(self.loc),
                "hit_rate": self.hits / total if total else 0.0}


def torch_dtype_of(dtype) -> torch.dtype:
    """numpy dtype -> the torch dtype of the same bytes."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class DeviceWarmCache(WarmCache):
    """Warm cache whose payload is a tensor on a torch device.

    `data` is a [C, D] tensor: `payload` when given (the parameter server
    passes its table's view of one [T, C, D] tensor, so every table's cache
    is one operand of the fused kernel), else a fresh allocation on
    `device`. Admission writes slots with one `index_copy_`; reads gather
    with `index_select` and copy to host numpy, bit-exact for the float
    dtypes the tables use. The tag store (`slot_row`/`slot_freq`/
    `slot_tick`/`loc`) is inherited unchanged and stays on the host.

    The device payload is what the fused lookup reads: the parameter
    server's `lookup_fused` launches the kernel over every table's `data`
    at once, without reading hit payloads back to the host.
    """

    supports_fused = True

    def __init__(self, capacity: int, dim: int, policy: str = "lfu",
                 dtype=np.float32, *, device="cuda",
                 payload: torch.Tensor | None = None):
        from repro_torch.utils import resolve_device
        self.device = (payload.device if payload is not None
                       else resolve_device(device))
        self._payload = payload
        super().__init__(capacity, dim, policy, dtype)

    def _alloc_payload(self) -> None:
        shape = (self.capacity, self.dim)
        if self._payload is not None:
            if tuple(self._payload.shape) != shape:
                raise ValueError(f"payload {tuple(self._payload.shape)} != "
                                 f"[capacity, dim] {list(shape)}")
            self.data = self._payload
        else:
            self.data = torch.zeros(shape, dtype=torch_dtype_of(self.dtype),
                                    device=self.device)
        if self.data.dtype != torch_dtype_of(self.dtype):
            raise ValueError(
                f"device warm cache holds {self.data.dtype}, the tables "
                f"{self.dtype}: a cast would break bit-exactness")

    def _read_payload(self, slots: np.ndarray) -> np.ndarray:
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        return self.data.index_select(0, idx).cpu().numpy()

    def _write_payload(self, slots: np.ndarray,
                       payload: np.ndarray) -> None:
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        self.data.index_copy_(
            0, idx, torch.from_numpy(np.ascontiguousarray(payload))
            .to(self.device))

    def device_bytes(self) -> int:
        return int(self.capacity * self.dim * self.dtype.itemsize)

    # -- fused lookup path ---------------------------------------------------
    def build_slot_map(self, rows: np.ndarray) -> np.ndarray:
        """rows [B, L] raw ids -> the fused kernel's slot map (the slot, or
        -1 = MISS).

        A pure tag-store read like `probe()`: no counter moves and the
        payload is not touched; the caller decides when an access becomes
        a hit or a miss (`touch()`/`admit()`)."""
        rows = np.asarray(rows)
        u, inv = np.unique(rows.ravel(), return_inverse=True)
        return self.probe(u)[inv].reshape(rows.shape)

    def lookup_fused(self, rows: np.ndarray, weights=None, *,
                     mode: str = "sum", backend: str = "auto", opts=None):
        """Cache-only fused lookup: [B, L] raw ids -> `FusedLookupResult`.

        Pooled values carry zero contribution at miss positions (the
        kernel's partial output, what degraded serving answers with); the
        miss list is exactly the looked-up rows the cache does not hold.
        Read-only, like `probe()`. On a payload on the card this launches
        the fused kernel (`fused_warm_lookup`); on the CPU it takes the
        plain version."""
        from repro_torch.kernels.embedding_bag.fused import fused_warm_lookup
        rows = np.asarray(rows)
        return fused_warm_lookup(self.data, self.build_slot_map(rows), rows,
                                 weights, mode=mode, backend=backend,
                                 opts=opts)
