#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 bench_port/run.py --workload hns.train --seed 1 --seconds 30 --trace 0

Needs the CUDA cards the cell asks for; see bench_port/README.md.
"""
import time

T_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import core  # noqa: E402

if __name__ == "__main__":
    core.fixed_caches()
    sys.exit(core.main(t_start=T_START))
