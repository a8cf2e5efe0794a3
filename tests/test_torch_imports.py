"""The port stands alone: nothing under src/repro_torch/, nor chip_smoke.py,
imports JAX or the JAX package `repro`."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(REPO)) for f in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_walk_sees_the_package():
    assert len(FILES) > 15
    ported = {str(f.relative_to(REPO / "src" / "repro_torch"))
              for f in FILES[:-1]}
    assert {"traffic/clock.py", "traffic/generators.py", "traffic/replay.py",
            "serving/slo.py", "serving/config.py", "ps/tuning.py",
            "checkpoint/manager.py", "examples/serve_dlrm.py",
            "storage/placement.py", "storage/tenancy.py",
            "storage/sharded.py", "serving/tenants.py",
            "storage/pool/transport.py", "storage/pool/worker.py",
            "storage/pool/pool.py", "data/pipeline.py",
            "optim/optimizers.py", "runtime/trainer.py",
            "kernels/embedding_bag/grad.py", "examples/train_dlrm.py",
            "examples/quickstart.py", "core/plan.py",
            "models/config.py", "models/layers.py", "models/attention.py",
            "models/moe.py", "models/ssm.py", "models/transformer.py",
            "models/encdec.py", "models/registry.py", "configs/__init__.py",
            "configs/phi4_mini_3_8b.py", "configs/deepseek_v2_lite_16b.py",
            "configs/jamba_1_5_large_398b.py", "configs/whisper_medium.py",
            "examples/lm_inference.py", "roofline/hw.py",
            "roofline/analyze.py", "roofline/report.py",
            "launch/__init__.py", "launch/mesh.py", "launch/sharding.py",
            "launch/steps.py", "launch/dryrun.py", "models/pspec.py"} <= ported
    configs = {f.name for f in (REPO / "src" / "repro" / "configs").glob(
        "*.py")}
    assert configs <= {f.name for f in FILES}
    sources = {f.name for f in (REPO / "src" / "repro_torch").rglob("*.cu")}
    assert {"embedding_bag.cu", "fused_lookup.cu"} <= sources


def test_spawned_pool_worker_loads_neither_jax_nor_the_reference():
    """The pool worker's import graph, as a spawned process builds it: the
    worker module in a fresh interpreter loads no `jax` and no `repro`."""
    code = ("import sys; import repro_torch.storage.pool.worker; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"{set(BANNED)!r}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ,
                              "PYTHONPATH": str(REPO / "src")}).stdout
    assert out.strip() == "[]"


def test_banned_import_is_caught(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom repro.core import hot_cache\n"
                   "def f():\n    import jax.numpy as jnp\n")
    assert sorted(m for m in _imported(bad)
                  if m.split(".")[0] in BANNED) == ["jax.numpy", "repro.core"]
