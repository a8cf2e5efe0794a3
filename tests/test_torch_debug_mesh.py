"""The debug-mesh cells of tests/test_distribution.py on the port: each
reduced step on a fake (2, 4) process group, on meta tensors, under
`OpCost` (per-device counts). A fake group is process-global, so every
case runs in a subprocess of its own.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



def _fake_mesh_run(code: str) -> str:
    """Run `code` after a fake group of 8 ranks and a (2, 4) cpu mesh
    `mesh` exist; returns stdout."""
    prelude = (
        "import torch, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "dist.init_process_group('fake', store=FakeStore(), world_size=8,"
        " rank=0)\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "mesh = init_device_mesh('cpu', (2, 4),"
        " mesh_dim_names=('data', 'model'))\n")
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


@pytest.mark.parametrize("mode", ["tp_fsdp", "fsdp_only"])
def test_debug_mesh_train_flops_per_device(mode):
    """phi4-mini's train step (reduced, kv heads 4 so every rule divides
    the (2, 4) mesh): per-device matmul flops x 8 equal the one-device
    count of the same step within 10 %."""
    out = _fake_mesh_run(f"""
import dataclasses
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import lm_inputs, make_lm_train_step
from repro_torch.models import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw_lowmem_init, adamw_lowmem_update
from repro_torch.roofline.analyze import OpCost
cfg = dataclasses.replace(reduced(get_config("phi4-mini-3.8b")),
                          num_kv_heads=4)
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
""")
    ratio = float(out.split("RATIO")[1].split()[0])
    assert abs(ratio - 1.0) <= 0.10, ratio


