"""The port stands alone: nothing under src/repro_torch/, nor chip_smoke.py,
imports JAX or the JAX package `repro`."""
import ast
import pathlib

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
            "storage/sharded.py", "serving/tenants.py"} <= ported
    sources = {f.name for f in (REPO / "src" / "repro_torch").rglob("*.cu")}
    assert {"embedding_bag.cu", "fused_lookup.cu"} <= sources


def test_banned_import_is_caught(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom repro.core import hot_cache\n"
                   "def f():\n    import jax.numpy as jnp\n")
    assert sorted(m for m in _imported(bad)
                  if m.split(".")[0] in BANNED) == ["jax.numpy", "repro.core"]
