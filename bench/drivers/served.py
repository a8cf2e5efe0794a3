"""The `served` driver: batches through the serving loop operators run.

The pool's batches go in as host numpy arrays through
`ServingSession.submit_batch`, one batch queued ahead of the one that
`poll` executes: the session's `device` engine assembles the batch, copies
it to the card, runs the forward and waits for the logits. A batch's
latency runs from the `submit_batch` call to the session's response tap
(`InferenceServer.on_batch`), which sees its logits on the host.

No cell uses it yet: the session's batch is paced by host assembly and a
pageable copy while the card idles. With tracing on, `poll` calls run
under the profiler as the `step` driver's dispatches do.
"""
from __future__ import annotations

import time

import torch

from bench.harness import trace as tracing
from bench.harness.window import BATCH, SLICE, Holder, LayerRanges, Window

LEAD = 2
SLICE_BATCHES = 20


class Served:
    def __init__(self, ctx):
        from repro_torch.serving.server import BatcherConfig
        from repro_torch.serving.session import ServingSession

        self.ctx = ctx
        self.batch = int(ctx.traffic["batch"])
        self.pool = [(d.cpu().numpy(), i.cpu().numpy())
                     for d, i in ctx.inputs.pool]
        self.session = ServingSession(
            ctx.program, batcher=BatcherConfig(max_batch=self.batch,
                                               max_wait_s=0.0))
        self.session.server.on_batch = self._tap
        self.k = 0                 # batches submitted
        self.done = 0              # batches executed
        self.k0 = self.k1 = None
        self.window = None
        self.holder = None
        self.mark = False

    def in_window(self, k: int) -> bool:
        return self.k0 is not None and self.k0 <= k and (
            self.k1 is None or k < self.k1)

    def submit(self) -> None:
        k = self.k
        self.k += 1
        dense, idx = self.pool[k % len(self.pool)]
        t0 = time.perf_counter()
        self.session.submit_batch(dense, idx, qid0=k * self.batch)
        t1 = time.perf_counter()
        if self.in_window(k):
            w = self.window
            w.pool_index.append(k % len(self.pool))
            w.t_dispatch.append(t0)
            w.dispatch_s.append(t1 - t0)
            w.t_done.append(None)
            w.logits.append(None)

    def _tap(self, batch, scores) -> None:
        t = time.perf_counter()
        k = batch[0].qid // self.batch
        if self.in_window(k):
            i = k - self.k0
            self.window.t_done[i] = t
            self.window.logits[i] = scores.astype("float32").copy()

    def poll(self) -> int:
        k = self.done
        if self.holder is not None and self.k0 is not None:
            self.holder.current = k - self.k0
        if self.mark:
            with torch.profiler.record_function(BATCH + str(k)):
                self.session.poll(force=True)
        else:
            self.session.poll(force=True)
        self.done += 1
        return k

    def advance(self) -> None:
        """Queue the next batch, then execute the oldest."""
        self.submit()
        if self.k - self.done > 1:
            self.poll()

    def drain(self) -> None:
        while self.done < self.k:
            self.poll()


def run(ctx) -> Window:
    s = Served(ctx)
    ctx.marks["session_built_s"] = time.perf_counter() - ctx.t_start
    for _ in range(2 * len(s.pool)):
        s.advance()
    s.drain()
    s.holder = Holder(ctx.model.checked_module(ctx.program), ctx.hold)
    launches0 = ctx.launches()
    t0 = time.perf_counter()
    win = Window(setup_s=t0 - ctx.t_start, seconds=ctx.seconds)
    s.window, s.k0 = win, s.k
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        s.advance()
    win.t_end = end
    s.k1 = s.k
    if ctx.trace:
        win.trace = traced_slice(s, ctx)
    s.drain()
    win.launches = (ctx.launches() - launches0) / max(1, s.k - s.k0)
    s.holder.remove()
    win.held = s.holder.held
    s.session.close()
    return win


def traced_slice(s: Served, ctx) -> "tracing.Readout":
    ranges = LayerRanges(ctx.model.layers(ctx.program))
    s.mark = True
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for _ in range(LEAD):
        s.advance()
    s.submit()
    first = s.poll() + 1
    with torch.profiler.record_function(SLICE):
        for _ in range(SLICE_BATCHES):
            s.submit()
            last = s.poll()
    s.drain()
    prof.stop()
    s.mark = False
    ranges.remove()
    ctx.trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(ctx.trace_path))
    return tracing.read(ctx.trace_path, batches=range(first, last + 1))
