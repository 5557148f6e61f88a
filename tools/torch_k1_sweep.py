#!/usr/bin/env python3
"""Kernel K1 of the PyTorch/CUDA port under other launch plans, on one card.

    python3 tools/torch_k1_sweep.py            # M = 1, 64, 128, 256, 2048
    python3 tools/torch_k1_sweep.py 8 512      # the sizes named

For each M (against a 100,352-row, 99,900-live, 512-deep gallery) it
prints the device time of each kernel of one ``cosine_top1`` call under
the default plan (``torch.profiler``), the host time of enqueueing one call,
and the streaming kernel's device time under other plans: tiles per
chunk × ring stages, launched through ``cosine_top1._launch``.  It is how
the constants of ``fire_tpu_torch/ops/cosine_top1.py:launch_plan`` were
chosen; ``chip_smoke.py`` holds the times that are reported.  The
profiler leaves launches slower for the rest of the process, so the host
time is taken first.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from fire_tpu_torch.ops import cosine_top1 as k1  # noqa: E402

ROWS, LIVE, DIM = 100_352, 99_900, 512


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def host_us(fn, reps=100):
    """Host time to enqueue one call (the queue is drained before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_us(fn, reps=10):
    """Mean device time of each kernel of one call, by kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    names = {"top1_partial": "stream", "top1_merge": "merge", "cast_bf16": "cast"}
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = next((v for k, v in names.items() if k in e.key), e.key[:40])
            out[name] = round(e.device_time_total / e.count, 1)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    sizes = [int(a) for a in sys.argv[1:]] or [1, 64, 128, 256, 2048]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    g = torch.from_numpy(unit_rows(rng, ROWS, DIM)).to(dev).to(torch.bfloat16)
    queries = {m: torch.from_numpy(unit_rows(rng, m, DIM)).to(dev) for m in sizes}
    k1.cosine_top1(queries[sizes[0]], g, LIVE)  # builds the kernel
    hosts = {m: host_us(lambda: k1.cosine_top1(queries[m], g, LIVE)) for m in sizes}
    n_tiles = -(-LIVE // k1.ROWS_PER_TILE)
    for m in sizes:
        q = queries[m]
        base = k1.launch_plan(m, LIVE, DIM, sms)
        print(f"M={m} default {base} blocks={base.blocks}: device us "
              f"{device_us(lambda: k1.cosine_top1(q, g, LIVE))}, host us per call {hosts[m]:.1f}",
              flush=True)
        for tiles in (1, 3, 6, 12, 24, 48):
            chunks = -(-n_tiles // tiles)
            if chunks * base.q_tiles > 8192:
                continue
            for stages in (3, 5, 8):
                shared = k1.shared_bytes(base.qt, DIM, stages)
                if shared > k1.MAX_SHARED_BYTES:
                    continue
                plan = k1.LaunchPlan(base.qt, base.q_tiles, tiles * k1.ROWS_PER_TILE, chunks,
                                     stages, shared)
                t = device_us(lambda: k1._launch(q, g, LIVE, plan))
                print(f"  tiles/chunk={tiles} blocks={plan.blocks} stages={stages} "
                      f"shared={shared}: {t}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
