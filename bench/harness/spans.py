"""The program's own spans around each device operation of a traced slice.

The port marks its layers with `repro_torch.tracing.span`, ranges named
`repro_torch.<layer>` in the profiler's Chrome trace. `trace.read` ties
each device operation to the benchmark's ranges (`bench.*`); this module
ties the same operations to the program's spans, found the same way: the
spans open on the launching thread at the launch, by the launch's
correlation id. A program without spans (an older tree) reads as no span
around any operation.

It reads the trace file a readout came from: the newest
`<workload>/trace.json` under the side records' directory whose device
operations include every one of the readout's.
"""
from __future__ import annotations

import collections
import json
from pathlib import Path

from bench.harness import runner
from bench.harness.trace import DEVICE_CATS, LAUNCH_CATS, _Intervals

PREFIX = "repro_torch."


def _read(path: Path, ops) -> list | None:
    """The span names (prefix stripped) around each of `ops`' launches in
    the trace at `path`, or None where `path` is not the readout's trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launches, corr_of = {}, {}
    spans = collections.defaultdict(list)
    for e in events:
        cat = str(e.get("cat", "")).lower()
        args = e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], e["ts"])
        elif cat in DEVICE_CATS:
            corr_of[e["name"], float(e["ts"]),
                    float(e.get("dur", 0.0))] = args.get("correlation")
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            name = e["name"][len(PREFIX):]
            spans[e["tid"], name].append(
                (e["ts"], e["ts"] + e["dur"], name))
    keys = [(op.name, float(op.start_us), float(op.dur_us)) for op in ops]
    if any(k not in corr_of for k in keys):
        return None
    found = {k: _Intervals(v) for k, v in spans.items()}
    out = []
    for k in keys:
        launch = launches.get(corr_of[k])
        if launch is None:
            out.append(frozenset())
            continue
        tid, ts = launch
        out.append(frozenset(name for (t, name), iv in found.items()
                             if t == tid and iv.find(ts) is not None))
    return out


def of(readout) -> list | None:
    """The program's spans around each of `readout.ops`, in order, or None
    where no trace file under the side records holds those operations."""
    paths = sorted(Path(runner.OUT).glob("*/trace.json"),
                   key=lambda p: p.stat().st_mtime, reverse=True)
    for path in paths:
        found = _read(path, readout.ops)
        if found is not None:
            return found
    return None


def ms_per_batch(readout, names) -> float | None:
    """Device ms a batch that the slice's batches launched under any of the
    spans `names`, or None where nothing ran under them."""
    found = of(readout)
    if not found or not readout.batches:
        return None
    seconds = 1e-6 * sum(op.dur_us for op, s in zip(readout.ops, found)
                         if s & set(names))
    return seconds * 1e3 / len(readout.batches) if seconds > 0 else None
