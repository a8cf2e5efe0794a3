"""Framed request/response RPC between the pool backend and its workers.

One duplex `multiprocessing` pipe per worker carries pickled frames
`(seq, verb, payload)` / `(seq, status, result)`. Payloads are arbitrary
picklable trees; numpy arrays above `SHM_INLINE_MAX` bytes are lifted out
of the frame into `multiprocessing.shared_memory` segments and travel as
name references (`_ShmArray`), so a large index batch or embedding block
crosses the process boundary as ONE shared-page memcpy instead of being
chunked through the pipe's 64 KiB kernel buffer.

Correlation & timeouts: calls on one transport are strictly serialized
(`call()` holds the transport lock across send+recv — the serving thread
and the refresh helper thread share each pipe), and every response must
echo its request's sequence number. A timeout, a dead worker process, or a
broken pipe raises the typed `WorkerDeadError` and marks the transport
dead: a stale late response must never be read as the answer to a newer
request, so a dead transport stays dead until the pool respawns the
worker. A verb that raised remotely surfaces as `RemoteCallError` carrying
the worker-side traceback; the transport stays healthy.

Segment lifecycle. Spawned workers share the parent's resource-tracker
process (the tracker fd rides the spawn preparation data), so a segment
has exactly ONE tracker entry however many processes map it, and in 3.10
`SharedMemory.unlink()` already drops that entry — the unlinking side owns
the tracker bookkeeping, nobody else touches it:

  * the SENDER creates a frame's segments;
  * the RECEIVER attaches, copies the payload out, closes AND unlinks
    (request/response is serialized, so by the time the next frame moves
    the previous frame's segments are consumed);
  * the sender releases its mapping — close only, no unlink — once the
    call completes; on an error path where the receiver may never have
    seen the frame, the sender unlinks its own segments instead.

A worker killed between frames can leak its in-flight response segments
until the resource tracker sweeps at interpreter exit; that is the crash
path, and the tracker guarantees the host is eventually clean.

A port of `repro/storage/pool/transport.py`, numpy and `multiprocessing`
only, as it is. Workers start with the spawn method, never fork: a CUDA
context does not survive `fork`, and the parent may hold one.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import threading
import time
from multiprocessing import shared_memory

import numpy as np

#: arrays strictly below this many bytes pickle inline through the pipe;
#: at/above it they ride a shared-memory segment (the pipe would chunk
#: them through a 64 KiB kernel buffer with two extra copies)
SHM_INLINE_MAX = 16 * 1024

#: default per-call timeout (seconds) — generous because a worker's first
#: verbs pay the spawn-side `import torch`, the CUDA context and the
#: construction of its units
DEFAULT_TIMEOUT = 120.0


class WorkerDeadError(RuntimeError):
    """The worker process died, timed out, or broke protocol mid-call.

    The transport is dead afterwards — the pool must respawn the worker
    (a late response from a timed-out call must never be correlated with
    a newer request).
    """

    def __init__(self, msg: str, *, worker: int | None = None):
        super().__init__(msg)
        self.worker = worker


class RemoteCallError(RuntimeError):
    """A verb raised inside the worker; carries the remote traceback.

    The worker caught the exception and kept serving — the transport is
    still healthy, only this call failed.
    """

    def __init__(self, worker: int, verb: str, err_type: str, msg: str,
                 remote_traceback: str):
        super().__init__(f"worker {worker} verb {verb!r} raised "
                         f"{err_type}: {msg}\n--- remote traceback ---\n"
                         f"{remote_traceback}")
        self.worker = worker
        self.verb = verb
        self.err_type = err_type


@dataclasses.dataclass(frozen=True)
class _ShmArray:
    """Frame placeholder for an array that rides a shm segment."""
    name: str
    dtype: str
    shape: tuple


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment. 3.10 re-registers on attach, but the
    tracker's name set is shared pool-wide and already holds the entry, so
    the re-add is a no-op — the eventual `unlink()` clears it."""
    return shared_memory.SharedMemory(name=name)


def create_segment(nbytes: int) -> shared_memory.SharedMemory:
    return shared_memory.SharedMemory(create=True, size=max(1, int(nbytes)))


def encode_payload(obj, segments: list) -> object:
    """Replace large ndarrays in a payload tree with `_ShmArray` refs.

    Created segments append to `segments`; the caller owns them until the
    peer consumes the frame (see the module docstring's lifecycle)."""
    if isinstance(obj, np.ndarray):
        if obj.nbytes < SHM_INLINE_MAX:
            return obj
        arr = np.ascontiguousarray(obj)
        seg = create_segment(arr.nbytes)
        np.ndarray(arr.shape, arr.dtype, buffer=seg.buf)[...] = arr
        segments.append(seg)
        return _ShmArray(seg.name, arr.dtype.str, arr.shape)
    if isinstance(obj, dict):
        return {k: encode_payload(v, segments) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        enc = [encode_payload(v, segments) for v in obj]
        return enc if isinstance(obj, list) else tuple(enc)
    return obj


def decode_payload(obj) -> object:
    """Materialize a received payload tree: shm refs are attached, copied
    out, closed and UNLINKED (the receiver consumes the segment)."""
    if isinstance(obj, _ShmArray):
        seg = attach_segment(obj.name)
        try:
            view = np.ndarray(obj.shape, np.dtype(obj.dtype), buffer=seg.buf)
            out = view.copy()
            del view
        finally:
            seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:
            pass
        return out
    if isinstance(obj, dict):
        return {k: decode_payload(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        dec = [decode_payload(v) for v in obj]
        return dec if isinstance(obj, list) else tuple(dec)
    return obj


def release_segments(segments: list) -> None:
    """Sender-side cleanup after the peer consumed the frame: drop the
    mapping only — the peer's unlink owned the tracker entry."""
    for seg in segments:
        try:
            seg.close()
        except BufferError:
            pass


def unlink_segments(segments: list) -> None:
    """Sender-side cleanup when the peer may never consume the frame
    (timeout / dead worker): reclaim the segments outright."""
    for seg in segments:
        try:
            seg.close()
        except BufferError:
            pass
        try:
            seg.unlink()
        except FileNotFoundError:
            pass


class WorkerTransport:
    """Pool-side handle on one worker process: RPC, liveness, teardown."""

    def __init__(self, proc, conn, worker: int):
        self.proc = proc
        self.conn = conn
        self.worker = worker
        self._lock = threading.Lock()
        self._seq = 0
        self._dead = False

    # -- liveness -----------------------------------------------------------
    @property
    def dead(self) -> bool:
        return self._dead or not self.proc.is_alive()

    @property
    def pid(self) -> int | None:
        return self.proc.pid

    def ping(self, timeout: float = DEFAULT_TIMEOUT) -> dict:
        """Heartbeat: the worker answers with pid + hosted unit ids."""
        return self.call("ping", timeout=timeout)

    # -- RPC ----------------------------------------------------------------
    def call(self, verb: str, payload: dict | None = None, *,
             timeout: float = DEFAULT_TIMEOUT):
        """One framed request/response round trip. Serialized per
        transport; raises `WorkerDeadError` (transport now dead) or
        `RemoteCallError` (worker still healthy)."""
        with self._lock:
            if self._dead:
                raise WorkerDeadError(
                    f"worker {self.worker} transport is dead (earlier "
                    f"timeout or crash) — respawn before calling",
                    worker=self.worker)
            self._seq += 1
            seq = self._seq
            segments: list = []
            try:
                frame = (seq, verb, encode_payload(payload, segments))
                self.conn.send(frame)
                deadline = time.monotonic() + timeout
                while not self.conn.poll(0.02):
                    if not self.proc.is_alive():
                        raise WorkerDeadError(
                            f"worker {self.worker} (pid {self.proc.pid}) "
                            f"died during {verb!r} "
                            f"(exitcode {self.proc.exitcode})",
                            worker=self.worker)
                    if time.monotonic() > deadline:
                        raise WorkerDeadError(
                            f"worker {self.worker} timed out after "
                            f"{timeout:.1f}s on {verb!r}",
                            worker=self.worker)
                rseq, status, result = self.conn.recv()
                if rseq != seq:
                    raise WorkerDeadError(
                        f"worker {self.worker} correlation violation: "
                        f"request {seq} answered by frame {rseq}",
                        worker=self.worker)
            except WorkerDeadError:
                self._dead = True
                unlink_segments(segments)
                raise
            except (EOFError, BrokenPipeError, OSError) as e:
                self._dead = True
                unlink_segments(segments)
                raise WorkerDeadError(
                    f"worker {self.worker} pipe failed during {verb!r}: "
                    f"{e}", worker=self.worker) from e
            release_segments(segments)
            if status == "err":
                raise RemoteCallError(self.worker, verb, result["type"],
                                      result["msg"], result["traceback"])
            return decode_payload(result)

    # -- teardown -----------------------------------------------------------
    def shutdown(self, timeout: float = 10.0) -> None:
        """Graceful stop: ask, join, escalate. Idempotent."""
        if not self._dead and self.proc.is_alive():
            try:
                self.call("shutdown", timeout=timeout)
            except (WorkerDeadError, RemoteCallError):
                pass
        self._dead = True
        self.proc.join(timeout=timeout)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=timeout)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
        try:
            self.conn.close()
        except OSError:
            pass

    def destroy(self) -> None:
        """Hard stop (crash-path cleanup before a respawn): no RPC."""
        self._dead = True
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=10.0)
        try:
            self.conn.close()
        except OSError:
            pass

    def kill(self) -> None:
        """Kill the worker PROCESS but leave the transport marked alive —
        the failure-injection hook the rollback tests use (the next call
        observes the death exactly as a real crash would)."""
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=10.0)


def spawn_worker(worker: int, ctx=None) -> WorkerTransport:
    """Start one pool worker process (spawn context: the parent's CUDA
    context and its threads cannot cross fork())."""
    from repro_torch.storage.pool.worker import worker_main
    if ctx is None:
        ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe(duplex=True)
    proc = ctx.Process(target=worker_main, args=(worker, child_conn),
                       name=f"pool-worker-{worker}", daemon=True)
    proc.start()
    child_conn.close()
    return WorkerTransport(proc, parent_conn, worker)
