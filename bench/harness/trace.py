"""Reads a traced slice from the profiler's Chrome trace.

Each device operation (kernel, copy, set) is tied by its correlation id to
the host call that launched it, and that call to the benchmark's ranges
that contain it on the host: the dispatch it belongs to
(`bench.batch.<k>`), the forward (`bench.forward`) and the model's layers
(`bench.<layer>`). The slice (`bench.slice`) spans the completions of a
known run of batches, so its length over their count is a step's time.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from pathlib import Path

from bench.harness.window import BATCH, LAYER, SLICE

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    batch: int | None            # dispatch that launched it
    ranges: frozenset            # layer ranges around its launch


@dataclasses.dataclass
class Readout:
    batches: list                # dispatch numbers completed in the slice
    window_s: float              # the slice's length
    busy_s: float                # device time with an operation running
    ops: list                    # DeviceOp of those batches
    top_ops: list                # [name, seconds] by device time
    idle_gaps: list              # [what the host was doing, seconds]

    def op_seconds(self, keep) -> float:
        return sum(op.dur_us for op in self.ops if keep(op)) * 1e-6


class _Intervals:
    """Host ranges of one name class on one thread, for containment."""

    def __init__(self, items):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]

    def find(self, t):
        """The tag of the range around `t` (ranges of a class never
        overlap on one thread), or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i][2]
        return None


def _union(intervals, lo, hi) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def read(path: Path, batches) -> Readout:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    wanted = set(batches)
    launches, device, host = {}, [], collections.defaultdict(list)
    slice_span = None
    for e in events:
        cat = str(e.get("cat", "")).lower()
        args = e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
        elif cat in HOST_CATS:
            host[e["tid"]].append(e)
            if e["name"] == SLICE:
                slice_span = (e["ts"], e["ts"] + e["dur"])
    if slice_span is None:
        raise RuntimeError(f"no {SLICE} range in {path}")
    by_thread = {}
    for tid, evs in host.items():
        batch_ranges = [(e["ts"], e["ts"] + e["dur"],
                         int(e["name"][len(BATCH):]))
                        for e in evs if e["name"].startswith(BATCH)]
        layer_ranges = collections.defaultdict(list)
        for e in evs:
            n = e["name"]
            if (e.get("cat") == "user_annotation" and n.startswith(LAYER)
                    and not n.startswith(BATCH) and n != SLICE):
                layer_ranges[n[len(LAYER):]].append(
                    (e["ts"], e["ts"] + e["dur"], n))
        by_thread[tid] = (_Intervals(batch_ranges),
                          {k: _Intervals(v) for k, v in layer_ranges.items()},
                          sorted((e["ts"], -e["dur"], e["name"]) for e in evs))
    ops, spans = [], []
    for e in device:
        corr = (e.get("args") or {}).get("correlation")
        launch = launches.get(corr)
        batch, ranges = None, frozenset()
        if launch is not None and launch[0] in by_thread:
            tid, ts = launch
            batch_iv, layer_iv, _ = by_thread[tid]
            batch = batch_iv.find(ts)
            ranges = frozenset(k for k, iv in layer_iv.items()
                               if iv.find(ts) is not None)
        op = DeviceOp(e["name"], e["ts"], e.get("dur", 0.0), batch, ranges)
        spans.append((op.start_us, op.start_us + op.dur_us, op, launch))
        if batch in wanted:
            ops.append(op)
    lo, hi = slice_span
    busy_us = _union([(s, e) for s, e, _, _ in spans], lo, hi)
    totals = collections.Counter()
    for op in ops:
        totals[op.name] += op.dur_us * 1e-6
    return Readout(
        batches=sorted(wanted), window_s=(hi - lo) * 1e-6,
        busy_s=busy_us * 1e-6, ops=ops,
        top_ops=[[n, s] for n, s in totals.most_common(TOP)],
        idle_gaps=_gaps(spans, lo, hi, by_thread))


def _gaps(spans, lo, hi, by_thread) -> list:
    """The longest idle stretches of the device inside [lo, hi], each named
    by what the host was running when it launched the operation that ended
    the gap: the layer range and the innermost host call around it."""
    spans = sorted(spans, key=lambda s: s[0])
    gaps, end = [], lo
    for s, e, op, launch in spans:
        if e <= lo or s >= hi:
            continue
        if s > end:
            gaps.append((s - end, op, launch))
        end = max(end, e)
    if hi > end:
        gaps.append((hi - end, None, None))
    gaps.sort(key=lambda g: -g[0])
    out = []
    for dur, op, launch in gaps[:TOP]:
        out.append([_host_label(op, launch, by_thread), dur * 1e-6])
    return out


def _host_label(op, launch, by_thread) -> str:
    if op is None:
        return "end of slice"
    if launch is None or launch[0] not in by_thread:
        return f"untracked launch of {op.name}"
    tid, ts = launch
    inner = None
    for start, neg_dur, name in by_thread[tid][2]:
        if start > ts:
            break
        if start - neg_dur >= ts:
            inner = name
    layer = "/".join(sorted(op.ranges)) or "outside the model"
    return f"{layer}: {inner or 'no host call'}"
