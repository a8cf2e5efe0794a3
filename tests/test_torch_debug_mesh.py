"""The debug-mesh cells of tests/test_distribution.py on the port: each
reduced step on a fake process group of 8 ranks (a (2, 4) mesh, and
(2, 2, 2) for the per-device flop counts), on meta tensors, under
`OpCost` (per-device counts). A fake group is process-global, so every
case runs in a subprocess of its own.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _fake_mesh_run(code: str, mesh: str = "2x4") -> str:
    """Run `code` after a fake group of 8 ranks and a cpu mesh `mesh`
    exist ((2, 4) over (data, model), or (2, 2, 2) over (pod, data,
    model)); returns stdout."""
    shape, names = MESHES[mesh]
    prelude = (
        "import torch, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "dist.init_process_group('fake', store=FakeStore(), world_size=8,"
        " rank=0)\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        f"mesh = init_device_mesh('cpu', {shape!r},"
        f" mesh_dim_names={names!r})\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", prelude + code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("arch,kind", [
    ("deepseek-v2-lite-16b", "train"),
    ("jamba-1.5-large-398b", "decode"),
    ("gemma3-27b", "prefill"),
    ("whisper-medium", "decode"),
])
def test_debug_mesh_step(arch, kind):
    """tests/test_distribution.py's debug-mesh cells: the reduced step on a
    fake (2, 4) mesh on meta runs under `OpCost` with per-device flops."""
    out = _fake_mesh_run(f"""
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import make_step
from repro_torch.models.config import ShapeConfig
from repro_torch.roofline.analyze import OpCost
b = make_step(reduced(get_config("{arch}")), ShapeConfig("t", 64, 8,
              "{kind}"), mesh)
with OpCost() as cost:
    b.fn(*b.inputs)
assert cost.total()["flops"] > 0, cost.total()
print("STEP_OK", cost.total()["flops"])
""")
    assert "STEP_OK" in out


# (mode, kv heads, mesh); the first two cases are the original ones (kv
# heads 4, so every rule divides the (2, 4) mesh). With 2 kv heads the
# heads cannot use `model` on (2, 4): the attention's queries are split
# along the sequence there instead of every rank repeating them
_TRAIN_CASES = [
    pytest.param("tp_fsdp", 4, "2x4", id="tp_fsdp"),
    pytest.param("fsdp_only", 4, "2x4", id="fsdp_only"),
    pytest.param("tp_fsdp", 2, "2x4", id="tp_fsdp-kv2"),
    pytest.param("fsdp_only", 2, "2x4", id="fsdp_only-kv2"),
    pytest.param("tp_fsdp", 4, "2x2x2", id="tp_fsdp-2x2x2"),
    pytest.param("fsdp_only", 4, "2x2x2", id="fsdp_only-2x2x2"),
    pytest.param("tp_fsdp", 2, "2x2x2", id="tp_fsdp-kv2-2x2x2"),
    pytest.param("fsdp_only", 2, "2x2x2", id="fsdp_only-kv2-2x2x2"),
]


@pytest.mark.parametrize("mode,kv,mesh", _TRAIN_CASES)
def test_debug_mesh_train_flops_per_device(mode, kv, mesh):
    """phi4-mini's train step (reduced, `kv` kv heads) on a fake mesh of
    8 ranks: per-device matmul flops x 8 equal the one-device count of
    the same step within 10 %."""
    out = _fake_mesh_run(f"""
import dataclasses
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import lm_inputs, make_lm_train_step
from repro_torch.models import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw_lowmem_init, adamw_lowmem_update
from repro_torch.roofline.analyze import OpCost
cfg = dataclasses.replace(reduced(get_config("phi4-mini-3.8b")),
                          num_kv_heads={kv})
shape = ShapeConfig("t", 64, 8, "train")
b = make_lm_train_step(cfg, shape, mesh, parallel_mode="{mode}")
with OpCost() as sharded:
    b.fn(*b.inputs)
model = build_model(cfg, device="meta")
x = lm_inputs(cfg, shape, model)
params = {{n: p for n, p in model.named_parameters()}}
opt = adamw_lowmem_init(params)
with OpCost() as one:
    loss = model.loss(x["tokens"], x["labels"], remat=True, vocab_chunk=512)
    grads = torch.autograd.grad(loss, list(params.values()))
    adamw_lowmem_update(params, dict(zip(params, grads)), opt)
print("RATIO", sharded.total()["flops"] * 8 / one.total()["flops"])
""", mesh)
    ratio = float(out.split("RATIO")[1].split()[0])
    assert abs(ratio - 1.0) <= 0.10, ratio


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_debug_mesh_prefill_flops_per_device(mesh, kv):
    """phi4-mini's prefill step (reduced, `kv` kv heads) on a fake mesh of
    8 ranks: per-device matmul flops x 8 equal the one-device prefill's
    within 10 %."""
    out = _fake_mesh_run(f"""
import dataclasses
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import lm_inputs, make_lm_serve_step
from repro_torch.models import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.roofline.analyze import OpCost
cfg = dataclasses.replace(reduced(get_config("phi4-mini-3.8b")),
                          num_kv_heads={kv})
shape = ShapeConfig("p", 64, 8, "prefill")
b = make_lm_serve_step(cfg, shape, mesh)
with OpCost() as sharded:
    b.fn(*b.inputs)
model = build_model(cfg, device="meta")
x = lm_inputs(cfg, shape, model)
with OpCost() as one:
    model.prefill(x["tokens"], x["cache"])
print("RATIO", sharded.total()["flops"] * 8 / one.total()["flops"])
""", mesh)
    ratio = float(out.split("RATIO")[1].split()[0])
    assert abs(ratio - 1.0) <= 0.10, ratio


def test_whisper_encoder_input_keeps_batch_shard():
    """whisper's train step (reduced, `fsdp_only`) on the fake (2, 4) mesh,
    its positions table sharded on d as the 256-rank mesh shards the
    full-width one: the encoder's input (frames + positions, the op where
    torch 2.11 dropped the batch shard) reaches the first block as
    Shard(0) over both axes, the batch over every rank."""
    out = _fake_mesh_run("""
from torch import nn
from torch.distributed.tensor import Shard
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import make_lm_train_step
from repro_torch.models import encdec
from repro_torch.models.config import ShapeConfig
b = make_lm_train_step(reduced(get_config("whisper-medium")),
                       ShapeConfig("t", 64, 8, "train"), mesh,
                       parallel_mode="fsdp_only", with_optimizer=False)
model = b.inputs[0]
model.enc_pos = nn.Parameter(model.enc_pos.detach().redistribute(
    mesh, [Shard(1), Shard(1)]))
seen = []
norm = encdec.layer_norm
def first_norm(x, *a, **k):
    seen.append(tuple(x.placements))
    return norm(x, *a, **k)
encdec.layer_norm = first_norm
b.fn(*b.inputs)
print("PLACEMENTS", seen[0])
""")
    assert "PLACEMENTS (Shard(dim=0), Shard(dim=0))" in out, out
