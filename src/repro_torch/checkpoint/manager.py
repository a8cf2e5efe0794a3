"""Atomic, restart-capable checkpointing + versioned model updates.

Layout (one directory per step), the same files as `repro.checkpoint`
writes, so a directory written by either package is read by the other:
    <root>/step_000100/
        manifest.json          # leaf keys, shapes, dtypes, step metadata
        arr_00000.npy ...      # one file per leaf
    <root>/LATEST               # atomic pointer file

A step holds the port's parameter dict (`model.state_dict()`: names such
as `bottom.w0` and `ebc.tables`, the `convert.py` naming), its leaves
ordered by key path — the order in which JAX flattens the reference's
parameter tree (`{"bottom", "embedding", "top"}`, keys sorted at every
level), so leaf i is the same weight in both packages.

Guarantees:
  * atomic publish — a step directory is visible in LATEST only after fsync;
    partial writes are never restored (preemption-safe).
  * device on restore — leaves are saved from the host and restored with
    `torch.from_numpy(...).to(device)` onto the device of the tensors
    they replace (or an explicit `device=`).
  * rotation — keep_last prunes old steps AND sweeps crashed partial saves
    (`.tmp_step_*` left behind by a writer killed mid-save).

Versioned embedding snapshots (online model updates, arxiv 2210.08804's
streaming incremental update requirement) ride the same directory with
their own `LATEST_VERSION` pointer under the identical tmp-dir +
fsync + `os.replace` publish discipline:

    <root>/v_000000001/         # kind="full": tables.npy [T, R, D]
    <root>/v_000000002/         # kind="delta": per-table changed rows
        manifest.json           #   against `base` (the previous version)
        t00003_rows.npy / t00003_vals.npy ...
    <root>/LATEST_VERSION       # atomic pointer file

`save_delta` falls back to a full snapshot when the changed-row ratio is
too high (a delta touching most rows costs more manifest + chain-walk
than it saves), so consumers see BOTH kinds in a long-running stream.
`ModelUpdateStream` is the publisher/consumer pair the serving layer
polls between batches.

A port of `repro/checkpoint/manager.py`; arrays may be given as numpy
arrays or tensors (on any device). A bfloat16 array is written as the JAX
package writes its `ml_dtypes` ones: numpy's 2-byte void (`|V2`) over the
16-bit patterns, with `"bfloat16"` as its manifest dtype. On reading, a
`|V2` file becomes bfloat16 again: `restore` returns bfloat16 tensors, and
the version records and snapshots carry bfloat16 values as their 16-bit
patterns (np.int16, `utils.host_array`'s form), which the storage
backends' `apply_update` takes as they are.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.utils import (BF16, dtype_name, host_array, host_dtype,
                               to_tensor)


class CheckpointError(RuntimeError):
    """Typed checkpoint validation/corruption failure (never an `assert`:
    asserts are stripped under `python -O`, which would silently disable
    corruption detection where it matters)."""


def _on_disk(arr: np.ndarray, name: str) -> np.ndarray:
    """The array `np.save` writes: bfloat16 bits as a 2-byte void."""
    if name == BF16:
        return np.ascontiguousarray(arr).view(np.dtype("V2"))
    return arr


def _load(path: str) -> np.ndarray:
    """`np.load`, with a 2-byte void (bfloat16) read as its 16-bit
    patterns."""
    arr = np.load(path)
    return arr.view(np.int16) if dtype_name(arr.dtype) == BF16 else arr


def _flatten(params: dict) -> list[tuple[str, object]]:
    """(dotted key, leaf) pairs of a flat (`state_dict`) or nested dict of
    tensors, ordered by key path as JAX orders a dict tree's leaves."""
    flat: dict[tuple[str, ...], object] = {}

    def walk(prefix: tuple[str, ...], node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + tuple(str(k).split(".")), v)
        else:
            flat[prefix] = node
    walk((), params)
    return [(".".join(path), flat[path]) for path in sorted(flat)]


class CheckpointManager:
    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        os.makedirs(root, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, params: dict, *,
             extra: Optional[dict] = None) -> str:
        """Publish `params` (a `state_dict`, or a nested dict of tensors)
        as `step`."""
        leaves = _flatten(params)
        tmp = os.path.join(self.root, f".tmp_step_{step:09d}")
        final = os.path.join(self.root, f"step_{step:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        keys = [k for k, _ in leaves]
        manifest = {
            "step": step,
            "treedef": f"keys{keys}",
            "num_leaves": len(leaves),
            "leaves": [],
            "extra": extra or {},
            "keys": keys,
        }
        for i, (_, leaf) in enumerate(leaves):
            arr, name = host_array(leaf)
            path = os.path.join(tmp, f"arr_{i:05d}.npy")
            np.save(path, _on_disk(arr, name))
            manifest["leaves"].append(
                {"shape": list(arr.shape), "dtype": name})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic publish
        self._write_latest(final)
        self._rotate()
        return final

    def _write_latest(self, final: str) -> None:
        self._write_pointer("LATEST", final)

    def _write_pointer(self, pointer: str, final: str) -> None:
        """Atomic pointer publish: tmp file + fsync + `os.replace`. Shared
        by the step LATEST and the version LATEST_VERSION pointers."""
        ptr = os.path.join(self.root, pointer)
        tmp = ptr + ".tmp"
        with open(tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, ptr)

    def _read_pointer(self, pointer: str) -> Optional[str]:
        ptr = os.path.join(self.root, pointer)
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.root, name)):
            return None
        return name

    def _rotate(self) -> None:
        entries = os.listdir(self.root)
        # crashed partial saves: a writer killed between makedirs and the
        # os.replace publish leaves `.tmp_step_*` behind, which the
        # `step_` prefix filter below never matches — they accumulated
        # forever. Any tmp dir still present here is a leftover (the
        # current save's tmp was already renamed before _rotate runs).
        for d in entries:
            if d.startswith(".tmp_step_") or d.startswith(".tmp_v_"):
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)
        steps = sorted(d for d in entries if d.startswith("step_"))
        for d in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        name = self._read_pointer("LATEST")
        return None if name is None else int(name.split("_")[1])

    def restore(self, like: dict, step: Optional[int] = None,
                device=None) -> tuple[dict, dict]:
        """Restore into the keys of `like` (a `state_dict` or nested dict
        of tensors): returns `({key: tensor}, extra)` with the flat dotted
        keys, each leaf on `device`, or on the device of the tensor it
        replaces when `device` is None. Load it with
        `model.load_state_dict(...)`."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like = _flatten(like)
        if manifest["num_leaves"] != len(leaves_like):
            raise CheckpointError(
                f"checkpoint has {manifest['num_leaves']} leaves, "
                f"model expects {len(leaves_like)}")
        out = {}
        for i, (key, leaf) in enumerate(leaves_like):
            arr = _load(os.path.join(d, f"arr_{i:05d}.npy"))
            want = manifest["leaves"][i]
            if list(arr.shape) != want["shape"]:
                raise CheckpointError(
                    f"leaf {i}: stored array shape {list(arr.shape)} does "
                    f"not match its manifest entry {want['shape']} — "
                    f"corrupt or partially written step_{step:09d}")
            if list(arr.shape) != list(leaf.shape):
                raise CheckpointError(
                    f"leaf {i} ({key}): stored shape {list(arr.shape)}, "
                    f"the model's is {list(leaf.shape)}")
            dev = device if device is not None else (
                leaf.device if torch.is_tensor(leaf) else "cpu")
            out[key] = to_tensor(arr, want["dtype"]).to(dev)
        return out, manifest["extra"]

    # -- versioned embedding snapshots (online model updates) ---------------
    def latest_version(self) -> Optional[int]:
        """Highest published model version, or None before the first
        `save_version`/`save_delta` publish."""
        name = self._read_pointer("LATEST_VERSION")
        return None if name is None else int(name.split("_")[1])

    def _version_dir(self, version: int) -> str:
        return os.path.join(self.root, f"v_{version:09d}")

    def _publish_version(self, version: int, manifest: dict,
                         payloads: dict) -> str:
        """Write `payloads` ({filename: ndarray}, as they go on disk) +
        manifest into a tmp dir, then publish atomically — the identical
        discipline `save` uses for steps (tmp dir -> fsync'd manifest ->
        os.replace -> pointer), so a consumer polling LATEST_VERSION can
        never observe a half-written version."""
        tmp = os.path.join(self.root, f".tmp_v_{version:09d}")
        final = self._version_dir(version)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for fname, arr in payloads.items():
            np.save(os.path.join(tmp, fname), np.asarray(arr))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic publish
        self._write_pointer("LATEST_VERSION", final)
        return final

    def _check_version(self, version: int) -> int:
        version = int(version)
        latest = self.latest_version()
        if latest is not None and version <= latest:
            raise CheckpointError(
                f"model versions are monotonic: cannot publish v{version} "
                f"after v{latest}")
        return version

    def save_version(self, version: int, tables: np.ndarray, *,
                     extra: Optional[dict] = None) -> str:
        """Publish a FULL embedding snapshot `tables` [T, R, D] as
        `version` (monotonically increasing). Every delta chain re-roots
        here, so a full snapshot bounds reconstruction cost."""
        version = self._check_version(version)
        tables, name = host_array(tables)
        return self._save_full(version, tables, name, extra)

    def _save_full(self, version: int, tables: np.ndarray, name: str,
                   extra: Optional[dict]) -> str:
        if tables.ndim != 3:
            raise CheckpointError(
                f"embedding snapshot must be [T, R, D], got shape "
                f"{list(tables.shape)}")
        manifest = {
            "version": version,
            "kind": "full",
            "shape": list(tables.shape),
            "dtype": name,
            "extra": extra or {},
        }
        return self._publish_version(version, manifest,
                                     {"tables.npy": _on_disk(tables, name)})

    def save_delta(self, version: int, changed_rows_per_table: dict, *,
                   full_fallback_ratio: float = 0.5,
                   extra: Optional[dict] = None) -> str:
        """Publish `version` as changed rows against the latest version.

        `changed_rows_per_table` maps table id -> (rows [n] int, values
        [n, D]); only those rows differ from the base. When the changed
        fraction exceeds `full_fallback_ratio` of all rows, a FULL
        snapshot (base + delta materialized) is published instead: a
        delta touching most rows costs more chain-walk on load than it
        saves on disk. The manifest's `kind` records which one actually
        landed."""
        version = self._check_version(version)
        base = self.latest_version()
        if base is None:
            raise CheckpointError(
                "save_delta needs a base snapshot — publish the first "
                "version with save_version()")
        base_manifest = self.load_version_manifest(base)
        T, R, D = base_manifest["shape"]
        name = base_manifest["dtype"]
        tables_entries = []
        payloads: dict[str, np.ndarray] = {}
        changed = 0
        for t in sorted(changed_rows_per_table):
            rows, values = changed_rows_per_table[t]
            rows = host_array(rows)[0].astype(np.int64)
            values, got = host_array(values)
            t = int(t)
            if not 0 <= t < T:
                raise CheckpointError(
                    f"delta v{version}: table {t} outside [0, {T})")
            if rows.size and (rows.min() < 0 or rows.max() >= R):
                raise CheckpointError(
                    f"delta v{version}: table {t} rows outside [0, {R})")
            if values.shape != (rows.size, D):
                raise CheckpointError(
                    f"delta v{version}: table {t} values shape "
                    f"{list(values.shape)} != [{rows.size}, {D}]")
            if values.dtype != host_dtype(name):
                raise CheckpointError(
                    f"delta v{version}: table {t} dtype {got} != "
                    f"snapshot dtype {name} — updates must preserve the "
                    f"table dtype bit-exactly")
            if rows.size == 0:
                continue
            changed += rows.size
            tables_entries.append({"table": t,
                                   "rows": f"t{t:05d}_rows.npy",
                                   "values": f"t{t:05d}_vals.npy",
                                   "num_rows": int(rows.size)})
            payloads[f"t{t:05d}_rows.npy"] = rows
            payloads[f"t{t:05d}_vals.npy"] = _on_disk(values, name)
        if changed > full_fallback_ratio * (T * R):
            tables = self.load_version(base)
            for t in sorted(changed_rows_per_table):
                rows, values = changed_rows_per_table[t]
                rows = host_array(rows)[0].astype(np.int64)
                if rows.size:
                    tables[int(t), rows] = host_array(values)[0]
            return self._save_full(version, tables, name, extra)
        manifest = {
            "version": version,
            "kind": "delta",
            "base": base,
            "shape": [T, R, D],
            "dtype": name,
            "tables": tables_entries,
            "extra": extra or {},
        }
        return self._publish_version(version, manifest, payloads)

    def load_version_manifest(self, version: int) -> dict:
        path = os.path.join(self._version_dir(version), "manifest.json")
        if not os.path.exists(path):
            raise CheckpointError(f"no model version v{version} under "
                                  f"{self.root}")
        with open(path) as f:
            return json.load(f)

    def load_update(self, version: int) -> dict:
        """One version as a normalized update record:
        `{"version", "kind", "shape", "dtype", "tables": {t: (rows,
        values)}}` — a full snapshot normalizes to whole-table row
        updates, so consumers apply both kinds through the same
        `apply_update(table, rows, values)` verb."""
        manifest = self.load_version_manifest(version)
        d = self._version_dir(version)
        T, R, _ = manifest["shape"]
        tables: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if manifest["kind"] == "full":
            full = _load(os.path.join(d, "tables.npy"))
            rows = np.arange(R, dtype=np.int64)
            for t in range(T):
                tables[t] = (rows, full[t])
        else:
            for entry in manifest["tables"]:
                rows = _load(os.path.join(d, entry["rows"]))
                vals = _load(os.path.join(d, entry["values"]))
                tables[int(entry["table"])] = (rows, vals)
        return {"version": manifest["version"], "kind": manifest["kind"],
                "base": manifest.get("base"), "shape": manifest["shape"],
                "dtype": manifest["dtype"], "tables": tables}

    def load_version(self, version: Optional[int] = None) -> np.ndarray:
        """Reconstruct the FULL [T, R, D] snapshot at `version` (default
        latest) by walking the delta chain back to its full base and
        replaying changed rows forward."""
        if version is None:
            version = self.latest_version()
            if version is None:
                raise CheckpointError(
                    f"no model versions under {self.root}")
        chain = []
        v = version
        while True:
            manifest = self.load_version_manifest(v)
            chain.append(v)
            if manifest["kind"] == "full":
                break
            v = manifest["base"]
        tables = _load(os.path.join(self._version_dir(chain[-1]),
                                    "tables.npy")).copy()
        for v in reversed(chain[:-1]):
            for t, (rows, vals) in self.load_update(v)["tables"].items():
                tables[t, rows] = vals
        return tables


class ModelUpdateStream:
    """Publisher/consumer pair over one versioned-snapshot root.

    The TRAINER side publishes retrained tables (`publish_full`) or
    changed rows (`publish_delta`, with the full-snapshot fallback);
    versions auto-increment. The SERVING side constructs a stream over
    the same root and calls `poll()` between batches: it returns the
    update records published since the last poll, in order, each ready
    to feed `storage.apply_update` — the atomic LATEST_VERSION pointer
    guarantees a poll never observes a half-written version.
    """

    def __init__(self, root, *, full_fallback_ratio: float = 0.5):
        self.ckpt = (root if isinstance(root, CheckpointManager)
                     else CheckpointManager(root))
        self.full_fallback_ratio = full_fallback_ratio
        # consumer cursor: start at whatever is already published —
        # a freshly attached consumer serves the current version, it
        # does not replay history
        self._cursor = self.ckpt.latest_version() or 0

    # -- publisher side -----------------------------------------------------
    def version(self) -> int:
        """Latest published version (0 before the first publish)."""
        return self.ckpt.latest_version() or 0

    def publish_full(self, tables: np.ndarray, *,
                     extra: Optional[dict] = None) -> int:
        v = self.version() + 1
        self.ckpt.save_version(v, tables, extra=extra)
        return v

    def publish_delta(self, changed_rows_per_table: dict, *,
                      extra: Optional[dict] = None) -> int:
        v = self.version() + 1
        self.ckpt.save_delta(
            v, changed_rows_per_table,
            full_fallback_ratio=self.full_fallback_ratio, extra=extra)
        return v

    # -- consumer side ------------------------------------------------------
    def poll(self) -> list[dict]:
        """Update records for every version published since the last
        poll (empty list when current). Advances the cursor: each record
        is delivered exactly once per stream instance."""
        latest = self.version()
        if latest <= self._cursor:
            return []
        out = [self.ckpt.load_update(v)
               for v in range(self._cursor + 1, latest + 1)]
        self._cursor = latest
        return out
