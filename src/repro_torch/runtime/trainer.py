"""Fault-tolerant training runtime.

Production behaviours implemented (and exercised by tests/test_torch_train.py):
  * checkpoint/restart — periodic saves via CheckpointManager; on (re)start
    the loop resumes from LATEST including the data-stream cursor.
  * preemption handling — SIGTERM/SIGINT request a final checkpoint at the
    next step boundary, then exit cleanly (restart-safe).
  * straggler mitigation — per-step wall times feed an EWMA; steps slower
    than `straggler_factor` x EWMA are logged so an orchestrator can drain
    the slow host.
  * crash-retry — transient step failures retry with exponential backoff up
    to `max_retries` before surfacing.
  * restore — `TrainLoop.restore()` writes the checkpoint into the
    state's own tensors, so their devices decide where it lands.

A port of `repro/runtime/trainer.py`. The TPU path's step is a functional
`jit` function, so a step that raises leaves the state as it was for
free. A step here may update tensors in place (the port's optimizers
do), and the contract is the step's own: compute every gradient, and
build every temporary, before writing any parameter, so that a failed
attempt has written nothing and a retry never applies an update twice.

The wall time of a step covers its device work: `float(loss)` waits for
the step's last kernel before the clock is read.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.utils import logger


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 2.5
    ewma_beta: float = 0.9
    max_retries: int = 2
    retry_backoff_s: float = 0.5


@dataclasses.dataclass
class StepStats:
    step: int
    loss: float
    wall_s: float
    straggler: bool


def _nest(flat: dict) -> dict:
    """{'a.b.c': x} -> {'a': {'b': {'c': x}}}: `CheckpointManager.restore`'s
    dotted keys back into the nested state they were flattened from."""
    out: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def _at(nested: dict, key) -> Any:
    """`nested`'s entry for a state key (a dotted key walks the levels
    `CheckpointManager` split it into)."""
    for part in str(key).split("."):
        nested = nested[part]
    return nested


@torch.no_grad()
def _assign(state: Any, restored: Any) -> Any:
    """`state` with the values of `restored`: tensors are overwritten in
    place (a model's parameters inside the state stay its parameters),
    other leaves are replaced."""
    if isinstance(state, dict):
        return {k: _assign(v, _at(restored, k)) for k, v in state.items()}
    if torch.is_tensor(state):
        return state.copy_(restored)
    return restored


class TrainLoop:
    """Owns (state, stream, step_fn) and runs the FT loop.

    step_fn(state, batch) -> (state, loss). `state` is a nested dict of
    tensors (params + optimizer + step counters).
    """

    def __init__(self, cfg: TrainLoopConfig, step_fn: Callable, state: Any,
                 stream, ckpt_dir: str):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.stream = stream
        self.ckpt = CheckpointManager(ckpt_dir, keep_last=cfg.keep_last)
        self.step = 0
        self._ewma: Optional[float] = None
        self._preempted = False
        self.history: list[StepStats] = []

    # -- preemption -----------------------------------------------------------
    def install_signal_handlers(self) -> dict:
        """Route SIGTERM and SIGINT to a checkpoint at the next step
        boundary; returns the handlers they replace, {signum: handler}."""
        def handler(signum, frame):
            logger.warning("signal %s: checkpoint at next boundary", signum)
            self._preempted = True
        return {signum: signal.signal(signum, handler)
                for signum in (signal.SIGTERM, signal.SIGINT)}

    # -- checkpoint/restore -----------------------------------------------------
    def save(self) -> str:
        return self.ckpt.save(self.step, self.state,
                              extra={"stream": self.stream.state_dict(),
                                     "step": self.step})

    def restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        flat, extra = self.ckpt.restore(self.state, latest)
        self.state = _assign(self.state, _nest(flat))
        self.stream.load_state_dict(extra["stream"])
        self.step = int(extra["step"])
        logger.info("restored at step %d", self.step)
        return True

    # -- the loop -----------------------------------------------------------------
    def _one_step(self, batch):
        for attempt in range(self.cfg.max_retries + 1):
            try:
                state, loss = self.step_fn(self.state, batch)
                return state, float(loss)
            except Exception:
                if attempt == self.cfg.max_retries:
                    raise
                backoff = self.cfg.retry_backoff_s * (2 ** attempt)
                logger.exception("step %d failed (attempt %d); retry in %.1fs",
                                 self.step, attempt, backoff)
                time.sleep(backoff)

    def run(self) -> list[StepStats]:
        cfg = self.cfg
        while self.step < cfg.total_steps and not self._preempted:
            batch = self.stream.next_batch()
            t0 = time.perf_counter()
            self.state, loss = self._one_step(batch)
            wall = time.perf_counter() - t0

            prev = self._ewma
            self._ewma = (wall if prev is None
                          else cfg.ewma_beta * prev + (1 - cfg.ewma_beta) * wall)
            straggler = prev is not None and wall > cfg.straggler_factor * prev
            if straggler:
                logger.warning("straggler: step %d took %.3fs (ewma %.3fs) — "
                               "flagging host for drain", self.step, wall, prev)
            self.history.append(StepStats(self.step, loss, wall, straggler))
            self.step += 1
            if self.step % cfg.log_every == 0:
                logger.info("step %d loss %.4f (%.3fs)", self.step, loss, wall)
            if self.step % cfg.checkpoint_every == 0:
                self.save()
        if self._preempted:
            path = self.save()
            logger.info("preemption checkpoint at %s", path)
        elif self.step >= cfg.total_steps:
            self.save()  # completion checkpoint (restart-extend safe)
        return self.history
