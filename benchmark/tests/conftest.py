"""The benchmark's tests: the benchmark's folder and the repo root on
``sys.path``, and torch held to a few threads (the CPU runs of the
harness drive full-width networks)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(min(4, os.cpu_count() or 1))
