"""The readings that a cell's correctness limits are set from.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 2

In one process, for each seed: the cell's set-up and a short window at the
cell's own load, then the check's numbers for the program against the
plain reference. For each control seed also the control's numbers: the
reference one precision step below what the configuration states (rows in
bfloat16, products in TF32), put in the program's place on the same
window. One JSON line a seed, then the largest program reading and the
smallest control reading of each number. The benchmark's own runs never
run the control.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402

import torch  # noqa: E402

from bench.harness import check, runner  # noqa: E402
from bench.harness.spec import load_cell  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    program, control = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        model, inputs, window, _ = runner.open_window(
            cell, seed, args.seconds, False, device, t0)
        ref = runner.reference_outputs(model, cell.config, inputs, window)
        line = {"seed": seed, "batches": len(window.logits)}
        if seed in args.seeds:
            program[seed] = line["program"] = check.readings(window, ref)
        if seed in args.control_seeds:
            ctl = runner.reference_outputs(model, cell.config, inputs,
                                           window, lower=True)
            control[seed] = line["control"] = check.readings(
                check.control_window(window, ctl), ref)
            del ctl
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del model, inputs, window, ref
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": cell.name, "program_seeds": len(program),
               "control_seeds": len(control)}
    for name in check.NUMBERS:
        if program:
            summary[f"{name}.program_max"] = max(r[name] for r in
                                                 program.values())
        if control:
            summary[f"{name}.control_min"] = min(r[name] for r in
                                                 control.values())
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
