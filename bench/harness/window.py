"""What a driver hands back from its measured window, and the ranges a
traced slice marks.

A driver offers a traffic mix's load for `seconds` and records, for every
batch it dispatched in the window, the host time of the dispatching call,
the time its logits were in host memory, and the logits themselves. It
keeps the checked module's output (the pooled bags) of the dispatches in
`hold`, chosen from the seed before the run. With tracing on it then runs a
short slice under the profiler (`bench.harness.trace`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SLICE = "bench.slice"
FORWARD = "bench.forward"
BATCH = "bench.batch."       # + dispatch number
LAYER = "bench."             # + layer name, e.g. bench.ebc


@dataclasses.dataclass
class Window:
    setup_s: float
    seconds: float
    pool_index: list = dataclasses.field(default_factory=list)
    t_dispatch: list = dataclasses.field(default_factory=list)
    t_done: list = dataclasses.field(default_factory=list)
    dispatch_s: list = dataclasses.field(default_factory=list)
    logits: list = dataclasses.field(default_factory=list)
    held: dict = dataclasses.field(default_factory=dict)
    t_end: float = 0.0
    launches: Optional[float] = None
    trace: Optional[object] = None       # bench.harness.trace.Readout
    setup_marks: dict = dataclasses.field(default_factory=dict)

    def completed_in_window(self) -> int:
        """Batches whose logits reached the host before the window closed."""
        return sum(1 for t in self.t_done if t <= self.t_end)

    def latencies_s(self) -> np.ndarray:
        return np.asarray(self.t_done) - np.asarray(self.t_dispatch)


class Holder:
    """A forward hook on the checked module that keeps its output of the
    dispatches in `wanted`: a reference, not a copy, so the timed path runs
    no extra work."""

    def __init__(self, module: torch.nn.Module, wanted):
        self.wanted = set(wanted)
        self.current = -1
        self.held: dict = {}
        self._handle = module.register_forward_hook(self._hook)

    def _hook(self, module, args, output):
        if self.current in self.wanted:
            self.held[self.current] = output
            if len(self.held) == len(self.wanted):
                self.remove()

    def remove(self) -> None:
        if self._handle is not None:
            self._handle.remove()
            self._handle = None


class LayerRanges:
    """Profiler ranges `bench.<layer>` around each call of the model's
    layers, set from forward pre-hooks and hooks."""

    def __init__(self, modules: dict):
        self._open: list = []
        self._handles = []
        for name, module in modules.items():
            self._handles.append(module.register_forward_pre_hook(
                self._enter(LAYER + name)))
            self._handles.append(module.register_forward_hook(self._exit))

    def _enter(self, name):
        def hook(module, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._open.append(rf)
        return hook

    def _exit(self, module, args, output):
        self._open.pop().__exit__(None, None, None)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
