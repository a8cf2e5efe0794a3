"""The port's SPMD layer against the JAX package's, mirroring
tests/test_distribution.py case for case: MoE expert parallelism equals
dense dispatch, the sharding rules (and every spec equal to JAX's) and
the vocab-parallel loss. The debug-mesh steps on a fake (2, 4) group are
in test_torch_debug_mesh.py (the two files each keep within a minute).

Gloo groups run in spawned processes (a module-level function each, a
`file://` store under tmp_path). JAX stays in this process on its single
CPU device, or in the `multidevice` fixture's subprocess.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JP

import _spmd_ranks
from repro.configs import LM_ARCHS as JAX_LM_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.sharding import cache_specs as jax_cache_specs
from repro.launch.sharding import param_specs as jax_param_specs
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models import pspec as jax_pspec
from repro.models.dlrm import DLRM as JaxDLRM
from repro_torch.configs import LM_ARCHS, get_config, reduced
from repro_torch.convert import lm_flat_leaves, lm_state_dict_from_numpy
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import cache_specs, param_specs
from repro_torch.models import build_model, build_plan, pspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_TOL = 1e-2          # tests/test_distribution.py's EP tolerance
LOSS_RTOL = 1e-3        # tests/test_distribution.py's vocab-parallel bound
MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


# ---------------------------------------------------------------------------
# MoE expert parallelism
# ---------------------------------------------------------------------------

def _moe_cfgs():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(
        "deepseek-v2-lite-16b")), moe_capacity_factor=8.0)
    return jcfg, _spmd_ranks.moe_cfg()


def test_moe_ep_matches_dense(multidevice, tmp_path):
    """The port's EP all-to-all (4 gloo ranks, experts over `model`) equals
    its dense dispatch and the JAX EP path (4 forced devices), within the
    JAX test's 1e-2, on the same routing, capacity and parameters."""
    jcfg, cfg = _moe_cfgs()
    params = jax.tree.map(np.asarray, jax_moe.moe_init(
        jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(1).standard_normal(
        (64, cfg.d_model)).astype(np.float32)
    flat = {k: v for k, v in params.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in params["shared"].items()})
    data = str(tmp_path / "moe.npz")
    np.savez(data, x=x, **flat)

    from repro_torch.models import moe
    tree = {k: torch.from_numpy(v) for k, v in flat.items()
            if not k.startswith("shared.")}
    tree["shared"] = {k: torch.from_numpy(v)
                      for k, v in params["shared"].items()}
    dense = moe.moe_ffn_local(tree, cfg, torch.from_numpy(x)).numpy()

    out = str(tmp_path / "ep.npy")
    mp.spawn(_spmd_ranks.moe_ep_rank,
             args=(str(tmp_path / "store"), data, out),
             nprocs=4)
    ep = np.load(out)

    jax_out = str(tmp_path / "jax_ep.npy")
    multidevice(f"""
import dataclasses, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.models.moe import MoEContext, moe_ffn_local
from repro.utils import shard_map_compat
cfg = dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                          moe_capacity_factor=8.0)
a = dict(np.load({data!r}))
p = {{k: jnp.asarray(v) for k, v in a.items()
     if k != "x" and not k.startswith("shared.")}}
p["shared"] = {{k.split(".")[1]: jnp.asarray(v) for k, v in a.items()
               if k.startswith("shared.")}}
mesh = Mesh(np.asarray(jax.devices()).reshape(4), ("model",))
ep = MoEContext(ep_axis="model", ep_size=4)
@shard_map_compat(mesh=mesh,
    in_specs=({{"router": P(), "wi": P("model"), "wg": P("model"),
               "wo": P("model"), "shared": P()}}, P("model")),
    out_specs=P("model"), check_vma=False)
def run(p, xs):
    return moe_ffn_local(p, cfg, xs, ep)
np.save({jax_out!r}, np.asarray(run(p, jnp.asarray(a["x"]))))
""", ndev=4)
    jax_ep = np.load(jax_out)
    err_dense = float(np.abs(ep - dense).max())
    err_jax = float(np.abs(ep - jax_ep).max())
    print("MAXERR dense", err_dense, "jax", err_jax)
    assert err_dense < MOE_TOL, err_dense
    assert err_jax < MOE_TOL, err_jax


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

def test_param_specs_rules():
    """tests/test_distribution.py's assertions on the port's rules
    (phi4-mini, a (2, 4) mesh): the port's layers are unstacked, so wq has
    no leading group dim."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    model = build_model(get_config("phi4-mini-3.8b"), device="meta")
    specs = param_specs(model, mesh)
    assert specs["embed"][0] == "model"              # vocab over TP
    wq = specs["layers.0.mixer.wq"]
    assert len(wq) == 2 and wq[-1] == "model"        # columns over TP
    assert all(a is None for a in specs["layers.0.norm1"])
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for name, p in model.named_parameters():
        for dim, ax in zip(p.shape, tuple(specs[name]) + (None,) * 8):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0, (
                name, p.shape, specs[name])


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch: str):
    cfg = jax_get_config(arch)
    if arch == "dlrm-production":
        return jax.eval_shape(JaxDLRM(cfg).init, jax.random.PRNGKey(0)), None
    model = jax_build_model(cfg)
    return (jax.eval_shape(model.init, jax.random.PRNGKey(0)),
            jax.eval_shape(lambda: model.init_cache(128, 32768)))


@functools.lru_cache(maxsize=None)
def _port_meta(arch: str):
    cfg = get_config(arch)
    if arch == "dlrm-production":
        from repro_torch.models import DLRM
        model = DLRM(cfg, device="meta")
        named = dict(model.named_parameters())
        named["ebc.tables"] = model.ebc.tables
        return named, None
    model = build_model(cfg, device="meta")
    return dict(model.named_parameters()), model.init_cache(128, 32768)


def _pad(spec, n: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


def _jax_param_specs_by_port_name(arch, jspecs):
    """The JAX spec tree keyed by the port's parameter names, the stacked
    group dim's leading None dropped."""
    if arch == "dlrm-production":
        out = {f"{t}.{k}": s for t in ("bottom", "top")
               for k, s in jspecs[t].items()}
        out["ebc.tables"] = jspecs["embedding"]["tables"]
        return out
    cfg = get_config(arch)
    return {n: (JP(*tuple(s)[1:]) if i is not None else s)
            for n, (s, i) in lm_flat_leaves(cfg, jspecs).items()}


def _jax_cache_specs_by_layer(arch, jcache):
    """The JAX cache spec tree as the port's per-layer list (stacked dims
    dropped)."""
    def drop(c):
        return type(c)(*(JP(*tuple(f)[1:]) for f in c))
    if arch == "whisper-medium":
        n = get_config(arch).num_decoder_layers or get_config(
            arch).num_layers
        return [drop(jcache.self_kv)] * n
    plan = build_plan(get_config(arch))
    out = list(jcache["prefix"])
    for _ in range(plan.num_groups):
        out += [drop(jcache["groups"][f"l{j}"])
                for j in range(len(plan.pattern))]
    return out + list(jcache["suffix"])


@pytest.fixture
def both_modes_reset():
    yield
    jax_pspec.set_parallel_mode("tp_fsdp")
    pspec.set_parallel_mode("tp_fsdp")


@pytest.mark.parametrize("mode", ["tp_fsdp", "fsdp_only"])
@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=["2x4", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list(LM_ARCHS) + ["dlrm-production"])
def test_param_specs_match_jax(arch, mesh_shape, axes, mode,
                               both_modes_reset):
    """Every parameter's spec (and, for the LM archs, every cache leaf's at
    decode_32k) equals the JAX package's, at full width."""
    assert set(LM_ARCHS) == set(JAX_LM_ARCHS)
    jax_pspec.set_parallel_mode(mode)
    pspec.set_parallel_mode(mode)
    jmesh = JaxAbstractMesh(mesh_shape, axes)
    mesh = AbstractMesh(mesh_shape, axes)
    jparams, jcache = _jax_abstract(arch)
    named, cache = _port_meta(arch)
    want = _jax_param_specs_by_port_name(arch, jax_param_specs(jparams,
                                                               jmesh))
    got = param_specs(named, mesh)
    assert set(got) == set(want)
    bad = {n: (tuple(got[n]), tuple(want[n])) for n, t in named.items()
           if _pad(got[n], t.ndim) != _pad(want[n], t.ndim)}
    assert not bad, bad
    if cache is None:
        return
    want_c = _jax_cache_specs_by_layer(arch, jax_cache_specs(jcache, jmesh))
    got_c = cache_specs(cache, mesh)
    got_c = got_c.self_kv if hasattr(got_c, "self_kv") else got_c
    assert len(got_c) == len(want_c)
    for i, (g, w) in enumerate(zip(got_c, want_c)):
        assert type(g).__name__ == type(w).__name__, i
        for field, gs, ws in zip(g._fields, g, w):
            assert _pad(gs, 5) == _pad(ws, 5), (i, field, gs, ws)


# ---------------------------------------------------------------------------
# Vocab-parallel loss
# ---------------------------------------------------------------------------

def _phi_reduced():
    return (jax_reduced(jax_get_config("phi4-mini-3.8b")),
            reduced(get_config("phi4-mini-3.8b")))


def test_vocab_parallel_loss_matches_unsharded(tmp_path):
    """The vocab-parallel loss on a gloo (2, 2) mesh (4 ranks: the JAX
    test's (2, 4) would take 8 processes here) equals the unsharded loss
    and the JAX loss within 1e-3 relative."""
    jcfg, cfg = _phi_reduced()
    jmodel = jax_build_model(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    # labels drawn apart from the tokens: with labels == tokens this
    # random model's loss is ~0 (the residual stream carries each token's
    # own embedding to the tied unembed), which would compare nothing
    toks, labels = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 4, 16)).astype(np.int64)
    ref_jax = float(jmodel.loss(params, toks, labels))
    sd = lm_state_dict_from_numpy(cfg, params)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        ref = float(model.loss(torch.from_numpy(toks),
                               torch.from_numpy(labels)))
    data = str(tmp_path / "lm.npz")
    np.savez(data, tokens=toks, labels=labels,
             **{k: v.numpy() for k, v in sd.items()})
    out = str(tmp_path / "loss.npy")
    mp.spawn(_spmd_ranks.vocab_loss_rank,
             args=(str(tmp_path / "store"), data, out),
             nprocs=4)
    got = float(np.load(out))
    print("LOSSES", ref_jax, ref, got)
    assert abs(got - ref) <= LOSS_RTOL * max(1.0, abs(ref)), (ref, got)
    assert abs(got - ref_jax) <= LOSS_RTOL * max(1.0, abs(ref_jax)), (
        ref_jax, got)
