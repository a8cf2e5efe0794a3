"""The port's serving path of the LM zoo (`prefill` / `decode_step`, the
whisper cached decode, MoE routing) against the JAX package on the CPU,
mirroring tests/test_models.py's decode checks, and the port's
`examples/lm_inference.py`.

f32 `reduced` configs on parameters from the JAX init: each step's logits
equal JAX's within rtol 1e-4 / atol 1e-4 and the port's own teacher
forcing within 2e-2 (the reference's tolerance); routing decisions equal
JAX's exactly, on inputs built to tie.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, reduced
from repro_torch.convert import load_reference_params
from repro_torch.examples import lm_inference
from repro_torch.models import build_model
from repro_torch.models import moe

RNG = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)
TEACHER_TOL = dict(rtol=2e-2, atol=2e-2)


def _pair(arch):
    jmodel = jax_build_model(jax_reduced(jax_get_config(arch)))
    params = jmodel.init(RNG)
    cfg = reduced(get_config(arch))
    model = load_reference_params(build_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))
    return cfg, jmodel, params, model


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-lite-16b",
                                  "rwkv6-7b", "gemma3-27b",
                                  "jamba-1.5-large-398b"])
def test_decode_matches_jax_and_teacher_forcing(arch):
    """prefill 20 + decode 4: each step's logits equal JAX's prefill /
    decode_step, and the port's own forward at that position. S=24 puts
    gemma3's window (16) inside the decode."""
    cfg, jmodel, params, model = _pair(arch)
    B, S, P = 1, 24, 20
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)
                                             ).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        full = model(tt).numpy()

    jcache = jmodel.init_cache(B, S, dtype=jnp.float32)
    jlogits, jcache = jax.jit(jmodel.prefill)(params, jnp.asarray(toks[:, :P]),
                                              jcache)
    cache = model.init_cache(B, S, dtype=torch.float32)
    logits, cache = model.prefill(tt[:, :P], cache)
    assert logits.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(logits[:, -1].numpy(), full[:, P - 1],
                               **TEACHER_TOL)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(P, S):
        jlogits, jcache = jdecode(params, jnp.asarray(toks[:, t:t + 1]),
                                  jcache, t)
        logits, cache = model.decode_step(tt[:, t:t + 1], cache, t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t],
                                   **TEACHER_TOL, err_msg=f"step {t}")


def test_whisper_decode_cached_matches_jax_and_full():
    cfg, jmodel, params, model = _pair("whisper-medium")
    B = 1
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(B, cfg.encoder_seq_len, cfg.d_model)
                        ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    jenc = jmodel.encode(params, jnp.asarray(frames))
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(frames))
        np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
        full, _ = model.decode(tt, enc)

        jcache = jmodel.init_cache(B, 8, dtype=jnp.float32)
        cache = model.init_cache(B, 8, dtype=torch.float32)
        for t in range(4):
            jstep, jcache = jmodel.decode(params, jnp.asarray(toks[:, t:t + 1]),
                                          jenc, cache=jcache, cache_pos=t)
            step, cache = model.decode(tt[:, t:t + 1], enc, cache=cache,
                                       cache_pos=t)
            np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                                       **TOL)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                       **TEACHER_TOL)


def _tied_router(d: int, e: int, seed: int) -> np.ndarray:
    """A router whose expert columns come in equal pairs: every token's
    probabilities tie between experts 2i and 2i+1."""
    half = np.random.default_rng(seed).normal(size=(d, e // 2)) * 0.5
    return np.repeat(half, 2, axis=1).astype(np.float32)


@pytest.mark.parametrize("t,e,k,cap", [(16, 8, 2, 4), (16, 8, 3, 2),
                                       (8, 64, 6, 1), (32, 16, 1, 64)])
def test_routing_decisions_equal_jax_on_ties(t, e, k, cap):
    """top-k experts (ties to the lower index, as `jax.lax.top_k`), their
    weights, positions in each expert and the capacity's keep mask: the
    port's `_route` + `_dispatch_local` against JAX's on the same inputs.
    (8, 64, 6, 1) is deepseek's decode at batch 8 under the published
    factor 2.0: capacity max(1, int(8*6/64*2)) = 1."""
    d = 32
    rng = np.random.default_rng(t * e + k)
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = _tied_router(d, e, seed=k)
    jw, je = jax_moe._route(jnp.asarray(w), jnp.asarray(x), k)
    jbuf, (_, _, jpos, _, jkeep) = jax_moe._dispatch_local(
        jnp.asarray(x), jw, je, e, cap)
    tw, te = moe._route(torch.from_numpy(w), torch.from_numpy(x), k)
    buf, (_, _, pos, _, keep) = moe._dispatch_local(
        torch.from_numpy(x), tw, te, e, cap)
    # the ties are real: each chosen pair's probabilities are equal
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w)))
    assert (probs[:, 0::2] == probs[:, 1::2]).all()
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the weights are f32 softmax values: each package's exp rounds its own
    # way by an ulp or two (1.4e-6 relative seen); the decisions are exact
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_moe_layer_and_aux_stats_match_jax(arch):
    """One MoE layer (routing, dispatch, experts, combine, shared expert)
    and its diagnostics, at the reduced config and at a capacity factor
    that drops tokens."""
    jcfg = jax_reduced(jax_get_config(arch))
    for cf in (jcfg.moe_capacity_factor, 0.5):
        jcfg_cf = dataclasses.replace(jcfg, moe_capacity_factor=cf)
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  moe_capacity_factor=cf)
        p = jax_moe.moe_init(RNG, jcfg_cf)
        tree = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), p)
        x = np.random.default_rng(5).normal(size=(24, cfg.d_model)
                                            ).astype(np.float32)
        want = jax_moe.moe_ffn_local(p, jcfg_cf, jnp.asarray(x))
        got = moe.moe_ffn_local(tree, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jstats = jax_moe.moe_aux_stats(p, jcfg_cf, jnp.asarray(x))
        stats = moe.moe_aux_stats(tree, cfg, torch.from_numpy(x))
        assert stats["capacity"] == jstats["capacity"]
        assert float(stats["drop_rate"]) == float(jstats["drop_rate"])
        np.testing.assert_allclose(float(stats["max_load"]),
                                   float(jstats["max_load"]), rtol=1e-6)
    # expert parallelism wants this rank's expert shard, not all experts
    with pytest.raises(ValueError):
        moe.moe_ffn_local(tree, cfg, torch.from_numpy(x),
                          moe.MoEContext(ep_size=2))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-lite-16b",
                                  "rwkv6-7b", "jamba-1.5-large-398b",
                                  "qwen2-vl-2b", "whisper-medium"])
def test_lm_inference_example_runs(arch, capsys):
    """The example for one arch of each family, on the host: its lines,
    and as many ids as asked for, each in the vocabulary."""
    out = lm_inference.main(["--device", "cpu", "--arch", arch,
                             "--tokens", "6", "--prompt-len", "5"])
    text = capsys.readouterr().out
    assert text.startswith(f"arch={out['cfg'].name} ")
    ids = out["decoded"] if arch == "whisper-medium" else out["continuation"]
    assert len(ids) == (7 if arch == "whisper-medium" else 6)
    assert all(0 <= i < out["cfg"].vocab_size for i in ids)
    if arch != "whisper-medium":
        assert len(out["prompt"]) == 5
        assert "greedy continuation ids:" in text
