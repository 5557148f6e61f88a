"""One run of a cell with one fault of ``test_benchmark_faults.py``
planted in the program:

    python benchmark/tests/fault_run.py <fault> --workload <name> --seed <n> --seconds <s> --trace 0

It prints what ``benchmark/run.py`` prints; the run has to come out not
correct."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]

import pytest  # noqa: E402

import run  # noqa: E402
import test_benchmark_faults as faults  # noqa: E402

if __name__ == "__main__":
    getattr(faults, sys.argv[1])(pytest.MonkeyPatch())
    sys.exit(run.main(sys.argv[2:]))
