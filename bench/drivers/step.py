"""The `step` driver: one batch after another, at most `inflight` out.

Before it dispatches a batch while `inflight` are outstanding, it waits for
the oldest one's logits, which the dispatch enqueued as a non-blocking copy
into pinned host memory behind the forward, with an event after it. The
card therefore never drains while the host dispatches, and every batch's
logits reach the host. A batch's latency runs from the dispatching call to
its logits in host memory.

Warm-up runs every pool batch twice through the same loop; the window
starts at the first timed dispatch. With tracing on, the loop goes on
without a drain into a slice of `SLICE_BATCHES` batches under the profiler
(after `LEAD` batches that let it settle), marked by ranges from the
benchmark's own code: the slice, each dispatch, the forward, and the
model's layers.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

from bench.harness import trace as tracing
from bench.harness.window import (BATCH, FORWARD, SLICE, Holder, LayerRanges,
                                  Window)

LEAD = 4
SLICE_BATCHES = 100


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model = ctx.program
        self.step = ctx.model.step
        self.pool = ctx.inputs.pool
        self.inflight = int(ctx.traffic["inflight"])
        batch = int(ctx.traffic["batch"])
        self.cuda = ctx.device.type == "cuda"
        self.bufs = [torch.empty(batch, dtype=torch.float32,
                                 pin_memory=self.cuda)
                     for _ in range(self.inflight)]
        self.events = ([torch.cuda.Event() for _ in range(self.inflight)]
                       if self.cuda else None)
        self.outstanding = collections.deque()
        self.k = 0
        self.k0 = None           # first dispatch of the window
        self.k1 = None           # first dispatch after it
        self.window = None
        self.holder = None
        self.mark = False

    def in_window(self, k: int) -> bool:
        return self.k0 is not None and self.k0 <= k and (
            self.k1 is None or k < self.k1)

    def dispatch(self) -> None:
        k = self.k
        self.k += 1
        slot = k % self.inflight
        dense, idx = self.pool[k % len(self.pool)]
        if self.holder is not None:
            self.holder.current = k - self.k0
        with torch.inference_mode(), contextlib.ExitStack() as marks:
            if self.mark:
                marks.enter_context(
                    torch.profiler.record_function(BATCH + str(k)))
            t0 = time.perf_counter()
            with (torch.profiler.record_function(FORWARD) if self.mark
                  else contextlib.nullcontext()):
                out = self.step(self.model, dense, idx)
            t1 = time.perf_counter()
            self.bufs[slot].copy_(out, non_blocking=self.cuda)
        if self.cuda:
            self.events[slot].record()
        self.outstanding.append(k)
        if self.in_window(k):
            w = self.window
            w.pool_index.append(k % len(self.pool))
            w.t_dispatch.append(t0)
            w.dispatch_s.append(t1 - t0)
            w.t_done.append(None)
            w.logits.append(None)

    def complete(self) -> int:
        k = self.outstanding.popleft()
        slot = k % self.inflight
        if self.cuda:
            self.events[slot].synchronize()
        t = time.perf_counter()
        if self.in_window(k):
            i = k - self.k0
            self.window.t_done[i] = t
            self.window.logits[i] = self.bufs[slot].numpy().copy()
        return k

    def advance(self) -> None:
        if len(self.outstanding) == self.inflight:
            self.complete()
        self.dispatch()

    def drain(self) -> None:
        while self.outstanding:
            self.complete()


def run(ctx) -> Window:
    loop = Loop(ctx)
    loop.advance()
    loop.drain()
    ctx.marks["first_batch_done_s"] = time.perf_counter() - ctx.t_start
    for _ in range(2 * len(loop.pool) - 1):
        loop.advance()
    loop.drain()
    if loop.cuda:
        torch.cuda.synchronize()
    loop.holder = Holder(ctx.model.checked_module(loop.model), ctx.hold)
    launches0 = ctx.launches()
    t0 = time.perf_counter()
    win = Window(setup_s=t0 - ctx.t_start, seconds=ctx.seconds)
    loop.window, loop.k0 = win, loop.k
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        if len(loop.outstanding) == loop.inflight:
            loop.complete()
            continue
        loop.dispatch()
    win.t_end = end
    loop.k1 = loop.k
    if ctx.trace:
        win.trace = traced_slice(loop, ctx)
    loop.drain()
    win.launches = (ctx.launches() - launches0) / (loop.k - loop.k0)
    loop.holder.remove()
    win.held = loop.holder.held
    return win


def traced_slice(loop: Loop, ctx) -> "tracing.Readout":
    ranges = LayerRanges(ctx.model.layers(loop.model))
    loop.mark = True
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for _ in range(LEAD):
        loop.advance()
    first = loop.complete() + 1
    with torch.profiler.record_function(SLICE):
        for _ in range(SLICE_BATCHES):
            loop.dispatch()
            last = loop.complete()
    loop.drain()
    if loop.cuda:
        torch.cuda.synchronize()
    prof.stop()
    loop.mark = False
    ranges.remove()
    ctx.trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(ctx.trace_path))
    return tracing.read(ctx.trace_path, batches=range(first, last + 1))
