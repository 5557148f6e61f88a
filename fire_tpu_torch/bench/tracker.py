"""``python -m fire_tpu_torch.bench tracker``: the port of
``bench_tracker.py``, the tracker-scan A/B.

K = 8 moving 80-px boxes a frame over B = 128 frames, drawn from
``default_rng(0)`` as ``bench_tracker.py:34-48`` draws them, tracked by
``sort_scan`` (JAX jits a ``lax.scan`` of ``sort_step``, ``:50-58``; the
port launches K2 once for the B frames and synchronises at the end) with
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


def random_sequence(seed: int, n_frames: int, k: int, n_obj: int, area: float = 900.0,
                    size=(40, 160), speed: float = 8.0, skip: int = 1, dropout: float = 0.15,
                    births: bool = True):
    """A seeded tracker input beside the bench's: ``n_obj`` objects on
    noisy linear paths in an ``area``-px square, with births, deaths and
    dropouts, packed into ``k`` padded slots a frame (the rest of the
    slots zero); (B, K, 4) float32 boxes and a (B, K) mask.  With
    ``skip`` > 1 only every skip-th frame carries detections, as the
    batched step's frame skip gives the scan; without ``births`` every
    object is there from the first frame."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, max(1, n_frames // 2) if births else 1, n_obj)
    life = rng.integers(n_frames // 2, 2 * n_frames, n_obj)
    pos = rng.uniform(50, 50 + area, (n_obj, 2))
    vel = rng.uniform(-speed, speed, (n_obj, 2))
    wh = rng.uniform(*size, (n_obj, 2))
    boxes = np.zeros((n_frames, k, 4), np.float32)
    mask = np.zeros((n_frames, k), bool)
    for f in range(n_frames):
        if f % skip != skip - 1:
            continue
        slot = 0
        for o in rng.permutation(n_obj):
            if slot == k or not (start[o] <= f < start[o] + life[o]) or rng.random() < dropout:
                continue
            p = pos[o] + vel[o] * (f - start[o]) + rng.normal(0, 2, 2)
            boxes[f, slot] = [*np.round(p), *np.round(wh[o] + rng.normal(0, 2, 2))]
            mask[f, slot] = True
            slot += 1
    return boxes, mask


def scan(cfg, boxes: torch.Tensor, mask: torch.Tensor):
    """The frames tracked from an empty table by ``sort_scan`` (one K2
    launch on the card, the ``sort_step`` loop on the CPU): the final
    table and each frame's count of confirmed tracks (a device tensor)."""
    from fire_tpu_torch.track.scan import sort_scan
    from fire_tpu_torch.track.sort import make_table

    table, out = sort_scan(make_table(cfg, boxes.device), boxes, mask, cfg)
    return table, out.mask.sum(dim=1)


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
