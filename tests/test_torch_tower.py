"""`MLPTower`'s two arithmetics on the CPU (`repro_torch.models.layers`).

On CUDA with no autograd graph each tower layer is one product with its
bias and ReLU in the epilogue (`torch._addmm_activation` / `torch.addmm`);
elsewhere it is `x @ w + b`, then `torch.relu`, as the JAX package
computes it. Here:

- the fused calls on CPU tensors meet the composition within f32
  rounding, layer by layer, at the widths of the benchmark's three
  configurations (dlrm-production, dlrm-benchmark, dlrm-dcnv2), with and
  without a final ReLU, the top towers' N = 1 last layer included;
- `tower_path` picks the path from the device, whether a graph is
  recorded and whether the activations are a DTensor, and `MLPTower`
  hands it what it observes;
- a forward that records a graph computes today's bits and gradients,
  even where the rule is made to take the CPU for CUDA;
- `epilogue_pays` keeps the composition on the one long, narrow layer
  (dlrm-production's first top layer) and `epilogue_layers` counts
  fused layers only;
- on a gloo (2, 2) mesh the DLRM serve step, its towers fused on each
  rank's rows, equals the fused forward without a mesh bit for bit.
"""
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _spmd_ranks
from repro_torch.configs.dlrm_dcnv2 import CONFIG as DCNV2
from repro_torch.configs.dlrm_production import CONFIG as PRODUCTION
from repro_torch.core.embedding import EmbeddingStageConfig
from repro_torch.models import DLRM, DLRMConfig, layers
from repro_torch.models.layers import MLPTower, epilogue_pays, tower_path

# the towers of the benchmark's configurations: dlrm-benchmark's widths
# are bench/configs/dlrm-benchmark.json's (64 + C(9, 2) = 100 features
# into its top tower)
TOWERS = {
    "production.bottom": (PRODUCTION.dense_features, *PRODUCTION.bottom_mlp),
    "production.top": (PRODUCTION.interaction_dim(), *PRODUCTION.top_mlp),
    "benchmark.bottom": (512, 512, 64),
    "benchmark.top": (100, 1024, 1024, 1024, 1),
    "dcnv2.bottom": (DCNV2.dense_features, *DCNV2.bottom_mlp),
    "dcnv2.top": (DCNV2.interaction_dim(), *DCNV2.top_mlp),
}
BATCH = 8
EPS = float(torch.finfo(torch.float32).eps)


def _tower(dims, seed=0):
    gen = torch.Generator().manual_seed(seed)
    tower = MLPTower(dims, torch.float32, generator=gen, device="cpu")
    with torch.no_grad():
        for i in range(tower.num_layers):       # a bias that matters
            getattr(tower, f"b{i}").normal_(0.0, 0.05, generator=gen)
    return tower, torch.randn((BATCH, dims[0]), generator=gen)


def _composed(tower, x, final_act):
    """The tower as written before its epilogue was fused."""
    for i in range(tower.num_layers):
        x = x @ getattr(tower, f"w{i}") + getattr(tower, f"b{i}")
        if i < tower.num_layers - 1 or final_act:
            x = torch.relu(x)
    return x


@pytest.fixture
def cpu_as_cuda(monkeypatch):
    """The path rule with the CPU taken for CUDA: the fused calls run on
    CPU tensors wherever the rule would fuse them on the card."""
    monkeypatch.setattr(layers, "tower_path", lambda device, graph, dtensor:
                        tower_path("cuda", graph, dtensor))


@pytest.mark.parametrize("final_act", [False, True])
@pytest.mark.parametrize("name", list(TOWERS))
def test_fused_meets_composition_within_rounding(name, final_act):
    tower, x = _tower(TOWERS[name])
    ws = [getattr(tower, f"w{i}") for i in range(tower.num_layers)]
    bs = [getattr(tower, f"b{i}") for i in range(tower.num_layers)]
    with torch.no_grad():
        h = x
        for i, (w, b) in enumerate(zip(ws, bs)):
            relu = i < tower.num_layers - 1 or final_act
            got = (torch._addmm_activation(b, h, w) if relu
                   else torch.addmm(b, h, w))
            want = h @ w + b
            want = torch.relu(want) if relu else want
            # each within γ(K+1)·(|h|·|w| + |b|) of the exact value
            bound = 2 * (w.shape[0] + 1) * EPS * (h.abs() @ w.abs() + b.abs())
            assert got.shape == want.shape
            assert bool(((got - want).abs() <= bound).all()), (name, i)
            h = want
        tower.epilogue_layers = 0
        whole = tower.run_layers(x, ws, bs, final_act, fuse=True)
    assert tower.epilogue_layers == sum(epilogue_pays(*w.shape) for w in ws)
    want = _composed(tower, x, final_act).detach()
    scale = want.abs().max().item()
    assert (whole - want).abs().max().item() <= 1e-5 * scale
    if not final_act and name.endswith(".top"):
        assert whole.shape == (BATCH, 1)         # the N = 1 layer


@pytest.mark.parametrize("name", list(TOWERS))
def test_epilogue_pays_on_every_layer_but_the_long_narrow_one(name):
    dims = TOWERS[name]
    pays = [epilogue_pays(k, n) for k, n in zip(dims[:-1], dims[1:])]
    # only dlrm-production's first top layer (31,503 -> 128) composes
    assert pays == [not (name == "production.top" and i == 0)
                    for i in range(len(pays))]


@pytest.mark.parametrize("device,graph,dtensor,want", [
    ("cuda", False, False, "fused"),
    ("cuda", False, True, "fused_local"),
    ("cuda", True, False, "composed"),
    ("cuda", True, True, "composed"),
    ("cpu", False, False, "composed"),
    ("cpu", False, True, "composed"),
    ("cpu", True, False, "composed"),
    ("cpu", True, True, "composed"),
])
def test_path_rule(device, graph, dtensor, want):
    assert tower_path(device, graph, dtensor) == want


@pytest.mark.parametrize("mode,params_grad,x_grad,graph", [
    ("inference", True, False, False),
    ("no_grad", True, True, False),
    ("grad", True, False, True),
    ("grad", False, True, True),
    ("grad", False, False, False),
])
def test_tower_observes_graph_and_device(monkeypatch, mode, params_grad,
                                         x_grad, graph):
    seen = []
    monkeypatch.setattr(layers, "tower_path", lambda *a: seen.append(a)
                        or tower_path(*a))
    tower, x = _tower((6, 5, 1))
    tower.requires_grad_(params_grad)
    x.requires_grad_(x_grad)
    ctx = {"inference": torch.inference_mode, "no_grad": torch.no_grad,
           "grad": torch.enable_grad}[mode]
    with ctx():
        tower(x)
    assert seen == [("cpu", graph, False)]
    assert tower.epilogue_layers == 0            # the CPU composes


@pytest.mark.parametrize("final_act", [False, True])
@pytest.mark.parametrize("cpu_rule", [False, True])
def test_graph_forward_keeps_bits_and_gradients(request, cpu_rule,
                                                final_act):
    if cpu_rule:
        request.getfixturevalue("cpu_as_cuda")
    tower, x = _tower(TOWERS["benchmark.top"], seed=3)
    x.requires_grad_(True)
    params = [x, *tower.parameters()]
    got = tower(x, final_act=final_act)
    want = _composed(tower, x, final_act)
    assert torch.equal(got, want)
    assert tower.epilogue_layers == 0
    g_got = torch.autograd.grad(got.sum(), params)
    g_want = torch.autograd.grad(want.sum(), params)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)


def test_counter_counts_fused_layers_only(cpu_as_cuda, monkeypatch):
    tower, x = _tower(TOWERS["dcnv2.top"])
    with torch.inference_mode():
        tower(x)
        tower(x, final_act=True)
    assert tower.epilogue_layers == 2 * tower.num_layers
    tower(x)                                     # records a graph
    assert tower.epilogue_layers == 2 * tower.num_layers
    monkeypatch.setattr(layers, "tower_path", tower_path)  # CPU: composed
    with torch.no_grad():
        tower(x)
    assert tower.epilogue_layers == 2 * tower.num_layers


def test_dtensor_serve_step_fuses_each_ranks_rows(tmp_path, cpu_as_cuda):
    stage, mlp = _spmd_ranks.DLRM_STAGE, _spmd_ranks.DLRM_MLP
    batch = _spmd_ranks.DLRM_BATCH
    cfg = DLRMConfig(embedding=EmbeddingStageConfig(**stage), **mlp)
    model = DLRM(cfg, device="cpu", seed=4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".b" in name:
                p.normal_(0.0, 0.05)
    rng = np.random.default_rng(5)
    dense = rng.normal(size=(batch, mlp["dense_features"])).astype(
        np.float32)
    idx = rng.integers(0, stage["rows"], size=(
        batch, stage["num_tables"], stage["pooling"])).astype(np.int32)
    with torch.inference_mode():
        want = model(torch.from_numpy(dense), torch.from_numpy(idx)).numpy()
    assert model.bottom.epilogue_layers == model.bottom.num_layers
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    data = str(tmp_path / "dlrm.npz")
    np.savez(data, dense=dense, indices=idx, **sd)
    out = str(tmp_path / "logits.npz")
    mp.spawn(_spmd_ranks.dlrm_serve_fused_rank,
             args=(str(tmp_path / "store"), data, out), nprocs=4)
    got = np.load(out)
    assert np.array_equal(got["logits"], want)
    assert got["counts"].tolist() == [model.bottom.num_layers,
                                      model.top.num_layers]
