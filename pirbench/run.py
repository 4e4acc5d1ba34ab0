#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 pirbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Exits non-zero, printing no result, when CUDA or enough cards are
missing, when the program cannot be imported, or when a module of JAX
or of the JAX package is loaded.  See ``harness/runner.py``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pirbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START))
