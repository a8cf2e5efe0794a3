"""Render the LM roofline records into a table.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir build/lm_roofline]

`chip_smoke.py`'s lm_serve phase writes one record a measured call
(`<arch>__<shape>.json` under `build/lm_roofline/`): the `OpCost` count of
the call on meta tensors and its roofline terms on the H100's constants,
the floor bound (each weight read once, the cache, the output), the time
measured on the card, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline.hw import HBM_BYTES, PEAK_FLOPS_BF16

ADVICE = {
    "compute": "raise tensor-core utilization (bf16/fp8 operands, larger "
               "tiles per SM, fuse the small ops between the matmuls)",
    "memory": "cut HBM traffic (fuse the elementwise ops and the f32 "
              "widening of the cache, in-place cache updates, read each "
              "weight once a step: batch more tokens per weight read)",
    "collective": "re-schedule NVLink collectives (overlap with compute, "
                  "reduce-scatter instead of all-reduce, shard to kill "
                  "regathers)",
}


def load(dirname: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def mfu_proxy(rec: dict) -> float:
    """model-useful FLOPs / (chips * peak * bound-time) — the roofline
    fraction this cell achieves if it runs at its dominant bound."""
    r = rec["roofline"]
    bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
    mf = rec.get("model_flops_global", 0.0)
    if not mf or not bound:
        return 0.0
    return mf / (r["num_chips"] * PEAK_FLOPS_BF16 * bound)


def row(rec: dict) -> str:
    r = rec["roofline"]
    per_dev = rec["memory"]["per_device_total"]
    fits = per_dev < HBM_BYTES
    measured = rec.get("measured_ms")
    floor = rec.get("floor_ms")
    return (f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
            f"| {r['compute_s']:.2e} | {r['memory_s']:.2e} "
            f"| {r['collective_s']:.2e} | {r['dominant']} "
            f"| {mfu_proxy(rec):.3f} | {per_dev/2**30:.2f} | "
            f"{'yes' if fits else 'NO'} "
            f"| {'-' if floor is None else f'{floor:.3f}'} "
            f"| {'-' if measured is None else f'{measured:.3f}'} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/lm_roofline")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    ok = [x for x in recs if x["status"] == "ok" and x["mesh"] == args.mesh]
    skipped = [x for x in recs if x["status"] == "skipped"
               and x["cell"].endswith(args.mesh)]
    cards = sorted({x.get("device", "") for x in ok} - {""})

    print("| arch | shape | mesh | compute_s | memory_s | collective_s "
          "| dominant | useful-FLOP frac | GiB/dev | fits | floor ms "
          "| measured ms |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for rec in sorted(ok, key=lambda x: (x["arch"], x["shape"])):
        print(row(rec))
    print(f"\nmeasured on: {', '.join(cards) or 'no card'}")
    print(f"skipped ({len(skipped)}): "
          + ", ".join(s["cell"] for s in skipped))
    if ok:
        worst = max(ok, key=lambda x: x.get("measured_ms", 0.0)
                    / max(1e-9, x.get("floor_ms") or 1e-9))
        print(f"\nfurthest from its floor: {worst['cell']} "
              f"({worst.get('measured_ms', 0.0) / max(1e-9, worst.get('floor_ms') or 1e-9):.1f}x); "
              f"{ADVICE[worst['roofline']['dominant']]}")


if __name__ == "__main__":
    main()
