"""The port's data streams against the TPU path's: on the same seed and
step, `repro_torch.data` makes the same batches as `repro.data`, bit for
bit, and a stream restored from its `state_dict` goes on with them."""
import numpy as np
import pytest

from repro.data import HETERO_MIXES as J_MIXES
from repro.data import DLRMQueryStream as JStream
from repro.data import TokenStream as JTokens
from repro_torch.data import (HETERO_MIXES, DLRMBatch, DLRMQueryStream,
                              TokenStream)

STREAMS = [
    dict(num_tables=3, rows=500, pooling=6, batch_size=8, seed=0),
    dict(num_tables=2, rows=2000, pooling=4, batch_size=5, dense_features=7,
         hotness="high_hot", seed=3),
    dict(num_tables=4, rows=300, pooling=5, batch_size=4, seed=11,
         hotness=["one_item", "random", "low_hot", "med_hot"]),
]


def _equal(got: DLRMBatch, want) -> None:
    for name in ("dense", "indices", "labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kw", STREAMS, ids=["med_hot", "high_hot", "mixed"])
def test_query_stream_batches_equal_jax(kw):
    port, ref = DLRMQueryStream(**kw), JStream(**kw)
    for _ in range(4):
        _equal(port.next_batch(), ref.next_batch())
    assert port.step == ref.step == 4


def test_heterogeneous_mix_equals_jax():
    assert HETERO_MIXES == J_MIXES
    port = DLRMQueryStream.heterogeneous("mix2", rows=200, pooling=3,
                                         batch_size=2, seed=5)
    ref = JStream.heterogeneous("mix2", rows=200, pooling=3, batch_size=2,
                                seed=5)
    assert port.num_tables == ref.num_tables == 250
    _equal(port.next_batch(), ref.next_batch())


@pytest.mark.parametrize("peek", [False, True])
def test_sample_trace_equals_jax(peek):
    kw = STREAMS[0]
    port, ref = DLRMQueryStream(**kw), JStream(**kw)
    np.testing.assert_array_equal(port.sample_trace(3, peek=peek),
                                  ref.sample_trace(3, peek=peek))
    assert port.step == ref.step == (0 if peek else 3)
    _equal(port.next_batch(), ref.next_batch())


def test_query_stream_state_dict_round_trips():
    kw = STREAMS[1]
    stream = DLRMQueryStream(**kw)
    for _ in range(3):
        stream.next_batch()
    st = stream.state_dict()
    assert st == JStream(**kw).state_dict() | {"step": 3}
    want = [stream.next_batch() for _ in range(2)]
    restored = DLRMQueryStream(**kw)
    restored.load_state_dict(st)
    for w in want:
        _equal(restored.next_batch(), w)
    other = DLRMQueryStream(**{**kw, "seed": kw["seed"] + 1})
    with pytest.raises(ValueError, match="seed"):
        other.load_state_dict(st)


def test_query_stream_rejects_wrong_hotness_count():
    with pytest.raises(ValueError):
        DLRMQueryStream(num_tables=2, rows=100, pooling=2, batch_size=2,
                        hotness=["med_hot"])


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_token_stream_equals_jax_and_round_trips(shard, num_shards):
    kw = dict(vocab_size=1000, seq_len=12, global_batch=4, seed=2,
              shard=shard, num_shards=num_shards)
    port, ref = TokenStream(**kw), JTokens(**kw)
    for _ in range(3):
        got, want = port.next_batch(), ref.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
    st = port.state_dict()
    assert st == ref.state_dict()
    restored = TokenStream(**kw)
    restored.load_state_dict(st)
    np.testing.assert_array_equal(restored.next_batch()["tokens"],
                                  port.next_batch()["tokens"])
    with pytest.raises(ValueError):
        TokenStream(**{**kw, "global_batch": 3, "num_shards": 2})
