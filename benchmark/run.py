#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

See benchmark/harness.py."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
