"""The port's production-mesh dry-run held to the JAX package's on the CPU.

Both sides run `run_cell` on the same reduced cells (`configs.reduced`
widths, the production shapes and meshes: 16x16 and 2x16x16), each in
subprocesses: the JAX side over 512 forced host devices, `get_config`
wrapped by `reduced` inside its process; the port over fake process
groups of 256 and 512 ranks on meta tensors. The yardstick is the
per-device flop count (the roofline's compute term):

- phi4-mini's train_4k (one pod and multi-pod) and prefill_32k (one pod)
  within a factor of 1.5 of JAX's. Its 8 KV heads (2 reduced) do not
  divide `model`: replicated attention read 13.7x and 15.7x here;
- rwkv6's multi-pod over one-pod ratio within 15 % of JAX's (0.50), and
  its multi-pod cell built and run within 30 s;
- within the port, phi4-mini train_4k's multi-pod flops x 512 within 10 %
  of the one-pod cell's x 256: the same global work.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHI4_CELLS = [("phi4-mini-3.8b", "train_4k", "single"),
              ("phi4-mini-3.8b", "train_4k", "multi"),
              ("phi4-mini-3.8b", "prefill_32k", "single")]
RWKV_SINGLE = ("rwkv6-7b", "train_4k", "single")
RWKV_MULTI = ("rwkv6-7b", "train_4k", "multi")
FLOPS_FACTOR = 1.5
SCALING_RTOL = 0.15
RWKV_MULTI_S = 30.0
GLOBAL_WORK_RTOL = 0.10

_JAX = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import repro.launch.dryrun as dryrun
from repro.configs import reduced
full = dryrun.get_config
dryrun.get_config = lambda arch: reduced(full(arch))
out = {}
for arch, shape, mesh in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, shape, mesh == "multi", out_dir=sys.argv[2])
    out[rec["cell"]] = {"flops": rec["roofline"]["per_device_flops"]}
print("RECORDS", json.dumps(out))
"""

_PORT = """
import json, sys
from repro_torch.launch.dryrun import run_cell
out = {}
for arch, shape, mesh in json.loads(sys.argv[1]):
    rec = run_cell(arch, shape, mesh == "multi", sys.argv[2],
                   use_reduced=True)
    out[rec["cell"]] = {"flops": rec["roofline"]["per_device_flops"],
                        "seconds": rec["lower_s"] + rec["compile_s"]}
print("RECORDS", json.dumps(out))
"""


def _start(code: str, cells, out_dir: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-W", "ignore", "-c", code, json.dumps(cells),
         out_dir], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _records(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    return json.loads(out.split("RECORDS", 1)[1])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax" | "port": {cell tag: record}}. JAX's cells and the port's
    short ones run side by side; the port's timed rwkv6 multi-pod cell
    runs after them, alone."""
    jax_dir = str(tmp_path_factory.mktemp("jax_dryrun"))
    port_dir = str(tmp_path_factory.mktemp("port_dryrun"))
    every = PHI4_CELLS + [RWKV_SINGLE, RWKV_MULTI]
    jax = _start(_JAX, every, jax_dir)
    port = _start(_PORT, PHI4_CELLS + [RWKV_SINGLE], port_dir)
    recs = {"jax": _records(jax), "port": _records(port)}
    recs["port"].update(_records(_start(_PORT, [RWKV_MULTI], port_dir)))
    return recs


def _tag(cell) -> str:
    return "__".join(cell)


@pytest.mark.parametrize("cell", PHI4_CELLS, ids=_tag)
def test_phi4_flops_per_device_match_jax(records, cell):
    port = records["port"][_tag(cell)]["flops"]
    jax = records["jax"][_tag(cell)]["flops"]
    assert 1 / FLOPS_FACTOR <= port / jax <= FLOPS_FACTOR, (port, jax)


def test_rwkv6_mesh_scaling_matches_jax(records):
    """The multi-pod over one-pod flop ratio of the same cell."""
    def scaling(side):
        return (records[side][_tag(RWKV_MULTI)]["flops"]
                / records[side][_tag(RWKV_SINGLE)]["flops"])
    port, jax = scaling("port"), scaling("jax")
    assert abs(port / jax - 1.0) <= SCALING_RTOL, (port, jax)


def test_rwkv6_multi_pod_cell_time(records):
    """The step's build and its one meta run (the record's lower_s +
    compile_s) on the 512-rank mesh."""
    assert records["port"][_tag(RWKV_MULTI)]["seconds"] <= RWKV_MULTI_S


def test_phi4_train_global_work_same_on_both_meshes(records):
    single = records["port"][_tag(PHI4_CELLS[0])]["flops"] * 256
    multi = records["port"][_tag(PHI4_CELLS[1])]["flops"] * 512
    assert abs(multi / single - 1.0) <= GLOBAL_WORK_RTOL, (multi, single)
