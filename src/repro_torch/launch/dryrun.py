"""Production-mesh dry-run: every (arch x shape) cell's step, once, on a
256- or 512-rank mesh that needs no device.

    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --include-dlrm --mesh both

The process joins a fake process group (`torch.testing._internal`'s
`fake` backend: collectives return at once) at world size 256 (single
pod, 16x16) or 512 (multi-pod, 2x16x16); the mesh is on `cpu`, and the
parameters, optimizer state, inputs and cache are meta DTensors. The step
runs once under `OpCost` (per-device flops, bytes and collective bytes)
and a live-bytes tracker, and one JSON record a cell goes to `--out`.

Record keys are the JAX dry-run's, with these meanings here:
  lower_s     seconds to build the step (model, specs, DTensors)
  compile_s   seconds of the one run on meta (nothing is compiled)
  memory      argument_bytes / output_bytes: the local shards of the
              step's inputs and outputs; alias_bytes: outputs that are
              inputs updated in place (the port's donation); temp_bytes:
              the peak of live local bytes made during the step;
              per_device_total = argument + output - alias + temp, and
              fits_80GB_HBM against `roofline/hw.py`'s HBM_BYTES (the
              card's counterpart of the JAX record's fits_16GiB_HBM)
  roofline    `roofline_terms` of the run's `OpCost`
`--reduced` runs the `configs.reduced` widths at the same shapes (the
tests' quick cell).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import utils
from repro_torch.configs import LM_ARCHS, get_config, reduced
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh
from repro_torch.launch.steps import (make_dlrm_serve_step,
                                      make_dlrm_train_step, make_step)
from repro_torch.models import model_flops, pspec
from repro_torch.models.config import SHAPES, shapes_for
from repro_torch.roofline.analyze import OpCost, roofline_terms
from repro_torch.roofline.hw import HBM_BYTES

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "..", "build", "dryrun")


class LiveBytes(TorchDispatchMode):
    """Peak of the local bytes of the tensors that ops make while it is
    active and that are still alive (a weakref finalizer a result).
    Views and in-place results are not new storage and are not counted."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func._schema.is_mutable:
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                n = utils.tree_bytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _init_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)


def _identities(tree) -> set:
    return {id(t) for t in tree_flatten(tree)[0] if torch.is_tensor(t)}


def _step_args(bundle):
    """The step's inputs as a flat list of tensors: the model's parameters
    and buffers, then the rest."""
    model, *rest = bundle.inputs
    return (list(model.parameters()) + list(model.buffers()), rest)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, *, use_reduced: bool = False) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    path = os.path.join(out_dir, tag + ".json")
    num_chips = math.prod(MULTI_POD if multi_pod else SINGLE_POD)
    _init_group(num_chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")

    t0 = time.time()
    cfg = get_config(arch)
    if arch == "dlrm-production":
        bundle = (make_dlrm_train_step(cfg, mesh) if shape_name == "train"
                  else make_dlrm_serve_step(cfg, mesh))
        mf = 0.0
    else:
        if use_reduced:
            cfg = reduced(cfg)
        shape = SHAPES[shape_name]
        if shape not in shapes_for(cfg):
            rec = {"cell": tag, "status": "skipped",
                   "reason": "long_500k needs sub-quadratic attention"}
            utils.write_json(path, rec)
            return rec
        bundle = make_step(cfg, shape, mesh)
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        mf = model_flops(cfg, tokens,
                         "train" if shape.kind == "train" else "serve")
    t_lower = time.time() - t0

    args, rest = _step_args(bundle)
    argument_bytes = utils.tree_bytes(args) + utils.tree_bytes(rest)
    in_ids = _identities(args) | _identities(rest)
    try:
        with OpCost() as cost, LiveBytes() as live:
            out = bundle.fn(*bundle.inputs)
    finally:
        pspec.set_parallel_mode("tp_fsdp")
    t_run = time.time() - t0 - t_lower
    out_tensors = [t for t in tree_flatten(out)[0] if torch.is_tensor(t)]
    if isinstance(out, tuple) and any(isinstance(o, torch.nn.Module)
                                      for o in out):
        out_tensors += args          # the model, updated in place
    output_bytes = utils.tree_bytes(out_tensors)
    alias_bytes = utils.tree_bytes([t for t in out_tensors
                                    if id(t) in in_ids])
    per_dev = argument_bytes + output_bytes - alias_bytes + live.peak
    terms = roofline_terms(cost.total(), num_chips=num_chips)
    rec = {
        "cell": tag, "status": "ok",
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "num_chips": num_chips,
        "lower_s": round(t_lower, 2), "compile_s": round(t_run, 2),
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "alias_bytes": alias_bytes,
            "temp_bytes": live.peak,
            "per_device_total": per_dev,
            "fits_80GB_HBM": bool(per_dev < HBM_BYTES),
        },
        "roofline": terms,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (terms["per_device_flops"] * num_chips)
                               if terms["per_device_flops"] else 0.0),
        "torch": torch.__version__,
    }
    utils.write_json(path, rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="production-mesh dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-dlrm", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced widths of configs.reduced")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in LM_ARCHS for shape in SHAPES]
        if args.include_dlrm:
            cells += [("dlrm-production", "serve"),
                      ("dlrm-production", "train")]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for mp in meshes:
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            try:
                rec = run_cell(arch, shape, mp, args.out,
                               use_reduced=args.reduced)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r, m = rec["roofline"], rec["memory"]
                    extra = (f" dom={r['dominant']}"
                             f" comp={r['compute_s']:.2e}s"
                             f" mem={r['memory_s']:.2e}s"
                             f" coll={r['collective_s']:.2e}s"
                             f" per_dev={m['per_device_total'] / 1e9:.2f}GB"
                             f" fits={m['fits_80GB_HBM']}")
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
            except Exception:
                failures += 1
                print(f"[dryrun] {tag}: FAILED", flush=True)
                traceback.print_exc()
                utils.write_json(os.path.join(args.out, tag + ".json"),
                                 {"cell": tag, "status": "failed",
                                  "error": traceback.format_exc()[-2000:]})
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
