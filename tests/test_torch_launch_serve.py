"""The port's LM serve steps (`repro_torch.launch.steps.make_lm_serve_step`)
on a gloo (2, 2) mesh against the same calls without a mesh: a prefill
of a [4, 8] prompt into a 16-long cache, then one decode step, logits
within tests/test_torch_models.py's rtol/atol 1e-4; and the decode
attention over a sequence-sharded cache (2 ranks). Ranks are spawned
processes (`_spmd_ranks`); parameters come from the JAX package's init,
as in test_torch_launch.py.
"""
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _spmd_ranks
from repro_torch.models import build_model
from test_torch_launch import _lm_case


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-lite-16b"])
def test_lm_serve_steps_on_mesh_match_unsharded(arch, tmp_path):
    """`make_lm_serve_step` on a gloo (2, 2) mesh: prefill of a [4, 8]
    prompt into a 16-long cache, then one decode step, against the same
    calls without a mesh (logits within tests/test_torch_models.py's
    rtol/atol 1e-4). deepseek's MLA cache is sequence-sharded there, so
    the cache writes land on the ranks that own each position."""
    cfg, _, _, _, data = _lm_case(arch, tmp_path)
    arrs = dict(np.load(data))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (4, 8))
    token = rng.integers(0, cfg.vocab_size, (4, 1))
    sd = {k: v for k, v in arrs.items() if k not in ("tokens", "labels")}
    np.savez(data, tokens=toks, token=token, **sd)
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    cache = model.init_cache(4, 16)
    want_first, cache = model.prefill(torch.from_numpy(toks), cache)
    want_second, _ = model.decode_step(torch.from_numpy(token), cache, 8)
    out = str(tmp_path / "serve.npz")
    mp.spawn(_spmd_ranks.lm_serve_rank,
             args=(arch, str(tmp_path / "store"), data, out), nprocs=4)
    got = dict(np.load(out))
    np.testing.assert_allclose(got["prefill"], want_first.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["decode"], want_second.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_decode_attention_over_sequence_shards(tmp_path):
    """The decode step's attention against a cache sharded along the
    sequence (2 gloo ranks, one KV head): each rank scores its half of the
    keys and the softmax is combined across ranks; equal to one device's
    within rtol/atol 1e-5 (f32; the sums regroup)."""
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 1, 2, 32)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, 16, 1, 32)).astype(np.float32)
    data = str(tmp_path / "attn.npz")
    np.savez(data, q=q, k=k, v=v)
    want = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True,
                             q_offset=torch.tensor(11), kv_len=12)
    out = str(tmp_path / "attn.npy")
    mp.spawn(_spmd_ranks.seq_decode_rank,
             args=(str(tmp_path / "store"), data, out), nprocs=2)
    np.testing.assert_allclose(np.load(out), want.numpy(), rtol=1e-5,
                               atol=1e-5)
