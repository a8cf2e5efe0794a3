#!/bin/bash
# The production-mesh dry-run table at full width: every (arch x shape)
# cell and the DLRM's serve and train steps on the given meshes, one
# process a cell, JOBS at a time (CPU only: no card is used), each cell
# capped at CELL_TIMEOUT seconds; records and logs under OUT; then one
# line a cell: GB a device; compute/memory/collective ms; build + run s.
#
#   bash scripts/dryrun_table.sh OUT [single|multi|both]
#
# The card's machine (8 cores) ran both meshes with JOBS=6 in about 450 s.
set -u
OUT=${1:?usage: dryrun_table.sh OUT [single|multi|both]}
MESHES=${2:-both}
JOBS=${JOBS:-6}
CELL_TIMEOUT=${CELL_TIMEOUT:-420}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH=$ROOT/src CUDA_VISIBLE_DEVICES=""
mkdir -p "$OUT/cells"
case $MESHES in both) MESHES="multi single";; esac
python -c "
from repro_torch.configs import LM_ARCHS
from repro_torch.models.config import SHAPES
for m in '$MESHES'.split():
    for a in LM_ARCHS:
        for s in SHAPES:
            print(a, s, m)
    print('dlrm-production serve', m)
    print('dlrm-production train', m)
" | xargs -P "$JOBS" -L 1 sh -c 'S=$(date +%s); timeout '"$CELL_TIMEOUT"' python -W ignore -m repro_torch.launch.dryrun --arch $0 --shape $1 --mesh $2 --out '"$OUT"'/cells > '"$OUT"'/log_$0_$1_$2.txt 2>&1; echo "$0 $1 $2 rc=$? s=$(( $(date +%s) - S ))" >> '"$OUT"'/done.txt'
python - "$OUT" <<'PY'
import glob, json, os, sys
for f in sorted(glob.glob(os.path.join(sys.argv[1], "cells", "*.json"))):
    r = json.load(open(f))
    if r["status"] != "ok":
        print(r["cell"], r["status"], r.get("reason", r.get("error", ""))[-300:])
        continue
    m, t = r["memory"], r["roofline"]
    print(r["cell"], "GB %.2f" % (m["per_device_total"] / 1e9),
          "flops %.4e" % t["per_device_flops"],
          "ms %.1f/%.1f/%.1f" % (1e3 * t["compute_s"], 1e3 * t["memory_s"],
                                 1e3 * t["collective_s"]),
          "s %.1f+%.1f" % (r["lower_s"], r["compile_s"]), r["torch"])
PY
