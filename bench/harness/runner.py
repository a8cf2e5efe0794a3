"""Runs one cell once and prints its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace 0|1

Set-up makes the cell's inputs and weights on the card from the seed,
builds the program on them and warms every shape up; the window then
offers the traffic's load for `--seconds`; after it, the peak device memory
is read, the program is freed, and the plain reference checks what the
timed path produced. With `--trace 1` the metrics are the cell's per-layer
ones, read from a profiled slice after the window; otherwise its
end-to-end ones. The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error. Side records go to `build/bench/<workload>/` in the checkout.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from bench.harness import check
from bench.harness.spec import ROOT, Cell, load_cell, load_module

#: top-level modules that may not be loaded where the result is printed:
#: JAX, the JAX package (`repro`; the port's `repro_torch` is another
#: name) and the JAX package's own benchmark
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
HOLD = 2                     # dispatches whose pooled bags are compared
OUT = ROOT / "build" / "bench"


@dataclasses.dataclass
class Context:
    """What a driver needs to run a cell's window."""

    model: object            # the cell's bench/models module
    program: object          # the system under test
    inputs: object
    traffic: dict
    seconds: float
    trace: bool
    hold: list
    t_start: float
    device: torch.device
    trace_path: Path
    launches: Callable[[], int]
    marks: dict              # set-up milestones, seconds from t_start


@dataclasses.dataclass
class MetricInput:
    """What a per-layer metric's reader reads."""

    trace: object            # bench.harness.trace.Readout
    work: list               # the model's work dict of each slice batch
    dispatch_s: list         # host seconds of each window dispatch


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def hold_positions(seed: int, pool_batches: int) -> list:
    rng = np.random.default_rng(seed & (2**64 - 1))
    return sorted(int(p) for p in rng.choice(
        2 * pool_batches, size=min(HOLD, 2 * pool_batches), replace=False))


def bag_launches() -> int:
    from repro_torch.kernels.embedding_bag import kernel
    return kernel.LAUNCHES


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def open_window(cell: Cell, seed: int, seconds: float, trace: bool,
                device: torch.device, t_start: float):
    """Set-up and the window: (the cell's model module, its inputs, the
    driver's Window, peak device bytes). The program is freed after."""
    cfg, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.empty(0, device=device)       # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)
    model = load_module("models", cfg["model"])
    driver = load_module("drivers", traffic["driver"])
    marks = {"started_s": time.perf_counter() - t_start}
    inputs = model.make_inputs(cfg, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    marks["inputs_made_s"] = time.perf_counter() - t_start
    program = model.build_program(cfg, inputs, device)
    if cuda:
        torch.cuda.synchronize(device)
    marks["program_built_s"] = time.perf_counter() - t_start
    ctx = Context(model=model, program=program,
                  inputs=inputs, traffic=traffic, seconds=seconds,
                  trace=trace, hold=hold_positions(seed, len(inputs.pool)),
                  t_start=t_start, device=device,
                  trace_path=OUT / cell.name / "trace.json",
                  launches=bag_launches, marks=marks)
    del program
    window = driver.run(ctx)
    window.setup_marks = marks
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx.program = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return model, inputs, window, peak


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"
    model, inputs, window, peak = open_window(cell, seed, seconds, trace,
                                              device, t_start)
    batch = int(traffic["batch"])
    result = {"correct": False, "attempted": len(window.logits) * batch,
              "failed": 0, "metrics": {}, "device": {
                  "platform": "gpu" if cuda else device.type,
                  "kind": (torch.cuda.get_device_name(device) if cuda
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}}
    work = {k: model.work(cfg, inputs, k) for k in range(len(inputs.pool))}
    if trace:
        r = window.trace
        result["device"]["busy_s"] = r.busy_s
        result["device"]["window_s"] = r.window_s
        m_in = MetricInput(
            trace=r, work=[work[k % len(inputs.pool)] for k in r.batches],
            dispatch_s=window.dispatch_s)
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(m_in)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = {"device_ops": r.top_ops,
                               "idle_gaps": r.idle_gaps}
    else:
        e2e = end_to_end(window, batch)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}

    reference = reference_outputs(model, cfg, inputs, window)
    values = check.readings(window, reference)
    missing = int(values["missing"])
    result["failed"] = missing * batch
    result["correct"], result["check"] = check.judge(values, cell.limits)
    side = {
        "workload": cell.name, "seed": seed, "seconds": seconds,
        "trace": trace, "nvidia_smi": nvidia_smi() if cuda else "",
        "torch": torch.__version__, "batches": len(window.logits),
        "completed_in_window": window.completed_in_window(),
        "batch_ms": {q: float(np.percentile(window.latencies_s(), q)) * 1e3
                     for q in (50, 95, 99, 100)},
        "dispatch_ms_mean": float(np.mean(window.dispatch_s)) * 1e3,
        "setup_marks": window.setup_marks,
        "bag_launches_per_forward": window.launches,
        "held": {str(p): window.pool_index[p] for p in window.held},
        "work": work, "result": result}
    return {"result": result, "side": side}


def end_to_end(window, batch: int) -> dict:
    """qps: queries whose logits reached the host in the window, over its
    seconds; batch_p95_ms: the 95th percentile over every batch dispatched
    in the window, from its dispatching call to its logits on the host;
    setup_s: process start to the first timed dispatch."""
    return {"qps": window.completed_in_window() * batch / window.seconds,
            "batch_p95_ms": float(np.percentile(window.latencies_s(), 95))
            * 1e3,
            "setup_s": window.setup_s}


def reference_outputs(model, cfg: dict, inputs, window,
                      lower: bool = False) -> dict:
    """Each pool batch the window drew, by the plain reference (or the
    control): (pooled of the held batches else None, logits)."""
    held = {window.pool_index[p] for p in window.held}
    out = {}
    for k in sorted(set(window.pool_index)):
        bags, logits = model.reference_outputs(cfg, inputs, k, lower=lower)
        out[k] = (bags if k in held else None, logits)
    return out


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="bench/run.py", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules that may not be loaded were: {bad}", file=sys.stderr)
        return 3
    side_path = OUT / cell.name / f"run_trace{args.trace}.json"
    side_path.parent.mkdir(parents=True, exist_ok=True)
    side_path.write_text(json.dumps(out["side"], indent=1, default=str))
    result = out["result"]
    print(json.dumps({"side_record": str(side_path.relative_to(ROOT)),
                      "nvidia_smi": out["side"]["nvidia_smi"],
                      "batch_ms": out["side"]["batch_ms"],
                      "bag_launches_per_forward":
                          out["side"]["bag_launches_per_forward"]}))
    sys.stdout.flush()
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
