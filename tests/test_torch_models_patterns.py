"""The LM zoo's archs whose stack plans have a leading dense layer or a
multi-layer pattern (jamba: 1 attn + 7 mamba with alternating MoE; gemma3:
5 local + 1 global and a suffix; deepseek: a dense prefix, then MLA+MoE),
held to the JAX package as tests/test_torch_models.py holds the others;
and every full config's parameter count and shapes, on the meta device.
"""
import jax
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import param_count as jax_param_count
from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.convert import lm_flat_leaves
from repro_torch.models import build_model, param_count
from test_torch_models import (PATTERN_ARCHS, RNG,
                               check_forward_loss_and_grads, make_pair)


@pytest.fixture(scope="module", params=PATTERN_ARCHS)
def pair(request):
    return make_pair(request.param)


def test_forward_loss_and_grads_match_jax(pair):
    """test_torch_models.py's check, for the patterned plans."""
    check_forward_loss_and_grads(pair)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_param_count_and_shapes_match_jax(arch):
    """At full width, without allocating: the meta-device build counts
    exactly JAX's parameters, and the converter maps every leaf of
    `jax.eval_shape(init)` onto a port parameter of the same shape."""
    cfg = get_config(arch)
    assert param_count(cfg) == jax_param_count(jax_get_config(arch))
    jmodel = jax_build_model(jax_get_config(arch))
    tree = jax.eval_shape(jmodel.init, RNG)
    model = build_model(cfg, device="meta")
    shapes = {name: tuple(leaf.shape if index is None else leaf.shape[1:])
              for name, (leaf, index) in lm_flat_leaves(cfg, tree).items()}
    assert shapes == {n: tuple(p.shape) for n, p in model.named_parameters()}


