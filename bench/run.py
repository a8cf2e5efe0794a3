"""Runs one cell of the port's benchmark once (see bench/harness/runner.py).

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace 0|1

from the root of a checkout: the cells are those of BENCHMARK.json, and the
program under test, `repro_torch`, is imported from the checkout's `src/`.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
