"""Whether what the timed path produced is correct.

After the window has closed, the plain reference (`bench/reference/`)
computes each pool batch again from the benchmark's own inputs, and the
check compares:

- `logit_gap`: every logit that reached the host in the window, against
  the reference's logit for the same query: the largest absolute gap over
  the largest reference logit of the pool;
- `pooled_gap`: the pooled bags that the timed path produced for the
  dispatches held from the seed, against the reference's bags: the largest
  absolute gap over the largest reference bag entry;
- `missing`: window batches whose logits never reached the host or are not
  finite.

Each number has its limit in `bench/limits/<workload>.json`, set from the
program's readings over many seeds and the control's (`bench/calibrate.py`).
"""
from __future__ import annotations

import copy

import numpy as np

NUMBERS = ("logit_gap", "pooled_gap", "missing")


def readings(window, reference: dict) -> dict:
    """The numbers the check compares. `reference[k]` holds pool batch k's
    (pooled, logits) by the reference; pooled may be None where no held
    dispatch drew that batch. Nothing held leaves `pooled_gap` None."""
    ref_logits = {k: v[1].double().cpu().numpy() for k, v in reference.items()}
    scale = max(float(np.abs(v).max()) for v in ref_logits.values())
    logit_gap, missing = 0.0, 0
    for k, got in zip(window.pool_index, window.logits):
        if got is None or not np.isfinite(got).all():
            missing += 1
            continue
        ref = ref_logits[k]
        logit_gap = max(logit_gap, float(np.abs(got - ref).max())
                        if got.shape == ref.shape else float("inf"))
    pooled_gap = 0.0 if window.held else None
    for pos, got in window.held.items():
        ref = reference[window.pool_index[pos]][0]
        if got.shape != ref.shape:
            pooled_gap = float("inf")
            continue
        pooled_gap = max(pooled_gap, float(
            (got.double() - ref.double()).abs().max()
            / ref.abs().max().double()))
    return {"logit_gap": logit_gap / scale, "pooled_gap": pooled_gap,
            "missing": float(missing)}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): each number at or under its
    limit; a number without a reading (nothing held) fails."""
    out, ok = {}, True
    for name in NUMBERS:
        limit = float(limits[name]["limit"])
        value = values.get(name)
        out[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, out


def control_window(window, control: dict):
    """The window as the control would have produced it: the control's
    logits and pooled bags in place of the program's, batch for batch."""
    ctl = copy.copy(window)
    ctl.logits = [control[k][1].float().cpu().numpy()
                  for k in window.pool_index]
    ctl.held = {pos: control[window.pool_index[pos]][0]
                for pos in window.held}
    return ctl

