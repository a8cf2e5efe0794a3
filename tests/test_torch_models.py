"""The port's LM zoo (`repro_torch.models`, `repro_torch.configs`) against
the JAX package on the CPU, mirroring tests/test_models.py.

Parameters come from the JAX init and are carried across by
`repro_torch.convert`; the same seeded numpy inputs go through both
packages. f32 (`reduced` configs): logits within rtol 1e-4 / atol 1e-4,
losses within rtol 1e-5, every parameter's gradient within rtol 1e-3 /
atol 1e-5 of `jax.grad`'s. The archs whose plans have a prefix or a
multi-layer pattern (jamba, gemma3, deepseek) run the same checks in
test_torch_models_patterns.py, so each file stays near a minute.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import LM_ARCHS as JAX_LM_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro_torch.configs import LM_ARCHS, get_config, reduced
from repro_torch.convert import (lm_state_dict_from_numpy,
                                 load_reference_params)
from repro_torch.models import build_model, build_plan, param_count
from repro_torch.models.config import shapes_for

RNG = jax.random.PRNGKey(0)
B, S = 2, 32


def _inputs(cfg, seed=0):
    """Seeded numpy inputs of the smoke test's shapes."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        frames = rng.normal(size=(B, cfg.encoder_seq_len, cfg.d_model)
                            ).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size, (B, cfg.decoder_text_len)
                            ).astype(np.int32)
        return {"frames": frames, "toks": toks}
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ve = (rng.normal(size=(B, cfg.vision_prefix_tokens, cfg.d_model))
          .astype(np.float32) if cfg.vision_prefix_tokens else None)
    return {"toks": toks, "ve": ve}


PATTERN_ARCHS = ("jamba-1.5-large-398b", "gemma3-27b",
                 "deepseek-v2-lite-16b")


def make_pair(arch):
    """(arch, port cfg, JAX model, JAX params, port model with them)."""
    jcfg = jax_reduced(jax_get_config(arch))
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(RNG)
    cfg = reduced(get_config(arch))
    model = load_reference_params(build_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))
    return arch, cfg, jmodel, params, model


@pytest.fixture(scope="module",
                params=[a for a in LM_ARCHS if a not in PATTERN_ARCHS])
def pair(request):
    return make_pair(request.param)


def _jax_forward_and_loss(cfg, jmodel, params, x):
    if cfg.is_encoder_decoder:
        frames, toks = jnp.asarray(x["frames"]), jnp.asarray(x["toks"])
        logits, _ = jax.jit(jmodel.decode)(
            params, toks, jax.jit(jmodel.encode)(params, frames))
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
            params, frames, toks, toks)
    else:
        toks = jnp.asarray(x["toks"])
        ve = None if x["ve"] is None else jnp.asarray(x["ve"])
        logits = jax.jit(jmodel.forward)(params, toks, vision_embeds=ve)
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
            params, toks, toks, vision_embeds=ve)
    return np.asarray(logits), float(loss), grads


def _port_forward_and_loss(cfg, model, x):
    model.zero_grad(set_to_none=True)
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(x["frames"])
        toks = torch.from_numpy(x["toks"]).long()
        with torch.no_grad():
            enc = model.encode(frames)
            assert enc.shape == (B, cfg.encoder_seq_len, cfg.d_model)
            logits, _ = model.decode(toks, enc)
        loss = model.loss(frames, toks, toks)
    else:
        toks = torch.from_numpy(x["toks"]).long()
        ve = None if x["ve"] is None else torch.from_numpy(x["ve"])
        with torch.no_grad():
            logits = model(toks, vision_embeds=ve)
        loss = model.loss(toks, toks, vision_embeds=ve)
    loss.backward()
    return logits.numpy(), float(loss.detach())


def test_forward_loss_and_grads_match_jax(pair):
    """The smoke forward + train-step gradient of every arch, both packages
    on the same parameters and inputs (the train step's optimizer comes
    with the SPMD layer)."""
    check_forward_loss_and_grads(pair)


def check_forward_loss_and_grads(pair):
    arch, cfg, jmodel, params, model = pair
    x = _inputs(cfg)
    j_logits, j_loss, j_grads = _jax_forward_and_loss(cfg, jmodel, params, x)
    logits, loss = _port_forward_and_loss(cfg, model, x)
    want_shape = (B, cfg.decoder_text_len if cfg.is_encoder_decoder else S,
                  cfg.vocab_size)
    assert logits.shape == want_shape
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, j_logits, rtol=1e-4, atol=1e-4)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)

    want = lm_state_dict_from_numpy(cfg, jax.tree.map(np.asarray, j_grads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g is not None, name
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    assert any(float(g.abs().max()) > 0 for g in grads.values()), \
        "gradients all zero"

    if not cfg.is_encoder_decoder:
        # the seq-chunked unembed gives the reference's number too
        ve = None if x["ve"] is None else jnp.asarray(x["ve"])
        toks = jnp.asarray(x["toks"])
        want_c = float(jax.jit(jmodel.loss, static_argnames="vocab_chunk")(
            params, toks, toks, vision_embeds=ve, vocab_chunk=8))
        toks = torch.from_numpy(x["toks"]).long()
        with torch.no_grad():
            got_c = float(model.loss(
                toks, toks, vocab_chunk=8, vision_embeds=None if ve is None
                else torch.from_numpy(x["ve"])))
        np.testing.assert_allclose(got_c, want_c, rtol=1e-5)


def test_archs_are_the_references():
    assert LM_ARCHS == JAX_LM_ARCHS
    for arch in LM_ARCHS:
        assert get_config(arch).__dict__ == jax_get_config(arch).__dict__
        assert reduced(get_config(arch)).__dict__ == \
            jax_reduced(jax_get_config(arch)).__dict__


def test_stack_plans():
    jamba = get_config("jamba-1.5-large-398b")
    plan = build_plan(jamba)
    assert plan.num_layers == 72
    assert len(plan.pattern) == 8
    assert plan.pattern[0].mixer == "attn"
    assert all(s.mixer == "mamba" for s in plan.pattern[1:])
    assert sum(s.ffn == "moe" for s in plan.pattern) == 4

    gemma = get_config("gemma3-27b")
    plan = build_plan(gemma)
    assert plan.num_layers == 62
    assert len(plan.suffix) == 2           # 62 = 10*6 + 2
    assert plan.pattern[-1].mixer == "attn"
    assert all(s.mixer == "attn_local" for s in plan.pattern[:-1])

    ds = get_config("deepseek-v2-lite-16b")
    plan = build_plan(ds)
    assert plan.num_layers == 27
    assert len(plan.prefix) == 1 and plan.prefix[0].ffn == "dense"
    assert plan.pattern[0].ffn == "moe" and plan.pattern[0].mixer == "mla"
    assert len(plan.layers()) == 27


def test_shape_skips_documented():
    """long_500k only for sub-quadratic archs."""
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        names = [s.name for s in shapes_for(cfg)]
        if cfg.family in ("hybrid", "ssm"):
            assert "long_500k" in names, arch
        else:
            assert "long_500k" not in names, arch


def test_full_param_counts_match_advertised():
    expected = {
        "jamba-1.5-large-398b": (380e9, 420e9),
        "llama4-scout-17b-a16e": (100e9, 115e9),
        "deepseek-v2-lite-16b": (14e9, 17e9),
        "rwkv6-7b": (7e9, 8e9),
        "phi4-mini-3.8b": (3.5e9, 4.2e9),
        "minitron-8b": (7e9, 8.5e9),
        "codeqwen1.5-7b": (6.5e9, 8.5e9),
        "gemma3-27b": (26e9, 30e9),
        "qwen2-vl-2b": (1.3e9, 2.2e9),
        "whisper-medium": (0.7e9, 1.0e9),
    }
    for arch, (lo, hi) in expected.items():
        n = param_count(get_config(arch))
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B outside [{lo/1e9},{hi/1e9}]"
