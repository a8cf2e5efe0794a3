"""The port's pool transport and worker process, on the CPU.

Mirrors the transport cases of tests/test_pool.py: the shared-memory codec
round trip (large arrays leave the frame, the receiver unlinks them), a
remote exception that leaves the worker serving, a killed worker that
surfaces as the typed `WorkerDeadError` and stays dead, and a call timeout.
A worker asked for a CUDA device where there is none raises remotely: the
port never moves a GPU request to the CPU.
"""
import numpy as np
import pytest

from repro_torch.ps import PSConfig
from repro_torch.storage import WorkerDeadError
from repro_torch.storage.pool.transport import (SHM_INLINE_MAX,
                                                RemoteCallError, _ShmArray,
                                                attach_segment,
                                                create_segment,
                                                decode_payload,
                                                encode_payload, spawn_worker)


def test_shm_codec_round_trip():
    big = np.arange(SHM_INLINE_MAX, dtype=np.float32).reshape(2, -1)
    small = np.arange(8, dtype=np.int64)
    payload = {"big": big, "nest": [small, {"s": "x", "n": 3}], "t": (big,)}
    segments = []
    frame = encode_payload(payload, segments)
    # large arrays left the frame, small ones ride inline
    assert isinstance(frame["big"], _ShmArray)
    assert isinstance(frame["t"][0], _ShmArray)
    assert isinstance(frame["nest"][0], np.ndarray)
    assert len(segments) == 2
    names = [s.name for s in segments]
    out = decode_payload(frame)
    assert np.array_equal(out["big"], big)
    assert np.array_equal(out["t"][0], big)
    assert np.array_equal(out["nest"][0], small)
    assert out["nest"][1] == {"s": "x", "n": 3}
    # the receiver consumed (unlinked) the segments
    for name in names:
        with pytest.raises(FileNotFoundError):
            attach_segment(name)
    for seg in segments:
        seg.close()


def test_worker_remote_error_keeps_transport_alive():
    t = spawn_worker(0)
    try:
        info = t.ping()
        assert info["worker"] == 0 and info["units"] == []
        # the port's own heartbeat fields: this process's launch counts;
        # no peak device bytes before it touches a card
        assert info["launches"] == {"bag": 0, "fused": 0}
        assert "max_memory_allocated" not in info
        with pytest.raises(RemoteCallError) as ei:
            t.call("no_such_verb")
        assert ei.value.err_type == "ValueError"
        assert not t.dead                       # verb failed, worker didn't
        # construct before attach_tables is a remote error with traceback
        with pytest.raises(RemoteCallError, match="attach_tables"):
            t.call("construct", {"units": [], "ps_cfg": None})
        assert t.ping()["pid"] == t.pid
    finally:
        t.shutdown()
    assert t.dead and not t.proc.is_alive()


def test_killed_worker_raises_typed_error_and_stays_dead():
    t = spawn_worker(3)
    try:
        assert t.ping()["worker"] == 3
        t.kill()                                # SIGKILL, transport unaware
        with pytest.raises(WorkerDeadError) as ei:
            t.ping()
        assert ei.value.worker == 3
        assert t.dead
        with pytest.raises(WorkerDeadError, match="respawn"):
            t.ping()                            # dead transports stay dead
    finally:
        t.shutdown()


def test_call_timeout_marks_transport_dead():
    t = spawn_worker(0)
    try:
        assert t.ping()["worker"] == 0
        with pytest.raises(WorkerDeadError, match="timed out"):
            t.call("sleep", {"seconds": 30.0}, timeout=0.05)
        assert t.dead                           # a late reply is never read
    finally:
        t.shutdown()


@pytest.mark.parametrize("device,threads", [("cuda", 1), ("cpu", 2)])
def test_worker_builds_its_units_on_the_device_it_is_given(device, threads):
    """A unit spec names its device: `cuda` where there is no card raises
    inside the worker (a `RemoteCallError` carrying the worker's
    traceback), never a server on the CPU; `cpu` builds and serves the
    shared segment's rows, with the thread count the pool gave it."""
    import torch
    tables = np.random.default_rng(0).normal(size=(2, 32, 8)).astype(
        np.float32)
    seg = create_segment(tables.nbytes)
    np.ndarray(tables.shape, tables.dtype, buffer=seg.buf)[...] = tables
    t = spawn_worker(0)
    try:
        out = t.call("attach_tables", {"name": seg.name,
                                       "dtype": tables.dtype.str,
                                       "shape": tables.shape,
                                       "threads": threads})
        assert out["threads"] == threads
        unit = {"unit_id": 0, "shard": 0, "table_ids": np.arange(2),
                "chunk": None, "device": device}
        cfg = PSConfig(hot_rows=4, warm_slots=4)
        if device == "cuda" and not torch.cuda.is_available():
            with pytest.raises(RemoteCallError, match="is_available"):
                t.call("construct", {"units": [unit], "ps_cfg": cfg})
            assert t.ping()["units"] == []      # nothing was built
        else:
            t.call("construct", {"units": [unit], "ps_cfg": cfg})
            idx = np.random.default_rng(1).integers(0, 32, (4, 2, 3))
            res = t.call("lookup", {"work": [{"unit_id": 0, "idx": idx}]})
            block = res["results"][0]["block"]
            np.testing.assert_array_equal(
                block, tables[np.arange(2)[None, :, None], idx])
            stats = t.call("stats")
            assert stats["host_tier_bytes"] == tables.nbytes    # a view
            assert stats["private_tier_bytes"] == 0
    finally:
        t.shutdown()
        seg.close()
        seg.unlink()
