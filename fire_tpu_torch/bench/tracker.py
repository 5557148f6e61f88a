"""``python -m fire_tpu_torch.bench tracker``: the port of
``bench_tracker.py``, the tracker-scan A/B.

K = 8 moving 80-px boxes a frame over B = 128 frames, drawn from
``default_rng(0)`` as ``bench_tracker.py:34-48`` draws them, tracked by
``sort_step`` frame by frame (JAX jits a ``lax.scan`` over it,
``:50-58``; the port loops on the host and synchronises at the end) with
four configurations: Hungarian (``lap``) or greedy assignment, 64 or 32
tracks.  Each is run once to warm up, then timed 8 times from the same
empty table; the best, in ms a frame (``:60-73``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fire_tpu_torch.bench.common import log, parser, print_result, sync

VARIANTS = {
    "lap_T64": dict(assignment="hungarian"),
    "lap_T32": dict(assignment="hungarian", max_tracks=32),
    "greedy_T64": dict(assignment="greedy"),
    "greedy_T32": dict(assignment="greedy", max_tracks=32),
}


def workload(batch: int = 128, k: int = 8):
    """(B, K, 4) float32 xywh boxes and a (B, K) all-true mask."""
    rng = np.random.default_rng(0)
    base = rng.uniform(100, 900, (k, 2))
    vel = rng.uniform(-3, 3, (k, 2))
    boxes = np.zeros((batch, k, 4), np.float32)
    for b in range(batch):
        base = base + vel
        boxes[b, :, :2] = base
        boxes[b, :, 2:] = 80
    return boxes, np.ones((batch, k), bool)


def scan(cfg, boxes: torch.Tensor, mask: torch.Tensor):
    """``sort_step`` over the frames from an empty table: the final table
    and each frame's count of confirmed tracks (a device tensor)."""
    from fire_tpu_torch.track.sort import make_table, sort_step

    table = make_table(cfg, boxes.device)
    counts = []
    for b in range(boxes.shape[0]):
        table, out = sort_step(table, boxes[b], mask[b], cfg)
        counts.append(out.mask.sum())
    return table, torch.stack(counts)


def run(device=None, batch: int = 128, trials: int = 8) -> dict:
    """ms a frame of each variant; returns the JSON record."""
    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.device import resolve_device

    device = resolve_device(device)
    boxes, mask = workload(batch)
    boxes, mask = torch.from_numpy(boxes).to(device), torch.from_numpy(mask).to(device)
    results = {}
    for name, kw in VARIANTS.items():
        cfg = TrackerConfig(**kw)
        with torch.inference_mode():
            scan(cfg, boxes, mask)  # warm
            sync(device)
            best = float("inf")
            for _ in range(trials):
                t0 = time.perf_counter()
                _, counts = scan(cfg, boxes, mask)
                counts.sum().item()
                best = min(best, time.perf_counter() - t0)
        results[name] = best * 1000.0 / batch
        log(f"[trk] {name}: {best * 1000:.2f} ms / {batch} frames = {results[name]:.3f} ms/frame")
    return {"metric": "tracker scan ms/frame", "variants": results}


def main(argv=None) -> int:
    ap = parser("bench_tracker.py on the port: tracker scan ms/frame")
    ap.add_argument("--batch", type=int, default=128,
                    help="frames in the scan (bench_tracker.py reads TRK_B)")
    args = ap.parse_args(argv)
    print_result(run(args.device, args.batch), args.device)
    return 0
