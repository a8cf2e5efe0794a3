"""Multi-process shard pool: `ShardedStorage`'s unit decomposition served
by worker processes over framed RPC, with one shared host cold tier per
host and per-worker device caches (each worker owns a CUDA context). See
`pool.py` for the backend, `worker.py` for the process side,
`transport.py` for the wire."""
from repro_torch.storage.pool.pool import PoolStorage
from repro_torch.storage.pool.transport import (RemoteCallError,
                                                WorkerDeadError,
                                                WorkerTransport)
from repro_torch.storage.pool.worker import worker_main

__all__ = ["PoolStorage", "RemoteCallError", "WorkerDeadError",
           "WorkerTransport", "worker_main"]
