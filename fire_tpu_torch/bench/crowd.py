"""``python -m fire_tpu_torch.bench crowd``: the port of
``tools/bench_crowd.py``, step cost against faces a frame.

The setup is the tool's (``bench_crowd.py:53-73``): ``FaceRecognition``
with YuNet and FaceNet-512 and the committed weights, trackers of 192
slots, ``max_faces`` raised to 128 after construction (the port's
detector reads ``cfg.engine.max_faces`` at each call, so the late change
reaches the step), a 99,000-row gallery, ``encode_k=128``, 32
identities.  For 1, 4, 16, 48 and 96 faces a frame, 8 rendered 720×1280
scenes cycled into a batch of B = 32: one warm-up step, then the best of
5 trials of 4 steps, in ms a frame (``:89-106``).

``detected_per_frame`` is the tool's: confirmed tracks a frame in the
warm-up step's results (``res.mask``).  The 8 scenes take turns frame by
frame, so a face seldom stays in one place long enough to be confirmed.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from fire_tpu_torch.bench.common import (TINY_ENGINE, WEIGHTS, log, parser, print_result, stage,
                                         unit_rows)

TINY = dict(batch=8, trials=1, hw=(120, 160), counts=(1, 4), rows=1_000)
MAX_FACES = 128
ENCODE_K = 128
MAX_TRACKS = 192


def setup_crowd(storage: str, device=None, rows: int = 99_000, engine_cfg=None):
    """``bench_crowd.py:53-73``: the recognizer, its engine with the crowd
    knobs, and the ``default_rng(0)`` that drew the gallery (the scenes
    come from it next)."""
    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition

    fr = FaceRecognition(detector_type="yunet", encoder_model_type="512", enable_logging=False,
                         storage_root=storage, tracker_cfg=TrackerConfig(max_tracks=MAX_TRACKS),
                         engine_cfg=engine_cfg, device=device)
    fr.engine.load_trained_detector(os.path.join(WEIGHTS, "yunet_synth.msgpack"))
    fr.engine.load_trained_encoder(os.path.join(WEIGHTS, "facenet512_synth.msgpack"))
    # crowd knobs: decode/NMS emit up to 128 faces per frame
    object.__setattr__(fr.cfg.engine, "max_faces", MAX_FACES)
    rng = np.random.default_rng(0)
    gal = unit_rows(rng, rows, fr.embedding_dim)
    fr.gallery.load_rows((i + 1, f"p{i}", gal[i].tobytes()) for i in range(gal.shape[0]))
    bse = BatchStreamEngine(fr.engine, fr.gallery, fr.cfg, TrackerConfig(max_tracks=MAX_TRACKS),
                            encode_k=ENCODE_K)
    return fr, bse, rng


def crowd_scenes(rng: np.random.Generator, identities, n: int, hw=(720, 1280), scenes: int = 8):
    """``bench_crowd.py:80-88``: ``scenes`` scenes of ``n`` faces that
    fit without overlap (``compose_scene`` tuples)."""
    from fire_tpu_torch.train.scenes import compose_scene

    fpx = max(28, min(140, int(np.sqrt(hw[0] * hw[1] / (4 * n)))))
    return [compose_scene(rng, identities, hw=tuple(hw), n_faces=(n, n),
                          face_px=(fpx, fpx + 20), occlusion_prob=0.0)
            for _ in range(scenes)]


def measure(bse, batch_dev: torch.Tensor, trials: int = 5) -> tuple:
    """``bench_crowd.py:89-100``: one warm-up step (its confirmed tracks
    a frame), then the best of ``trials`` trials of 4 steps, ms a frame."""
    b = batch_dev.shape[0]
    res = bse.process_batch(batch_dev)
    tracked = float(res.mask.sum()) / b
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(4):
            bse.process_batch(batch_dev)
        ts.append((time.perf_counter() - t0) / (4 * b) * 1000)
    return min(ts), tracked


def run(device=None, batch: int = 32, trials: int = 5, hw=(720, 1280),
        counts=(1, 4, 16, 48, 96), rows: int = 99_000, engine_cfg=None) -> dict:
    """The curve over ``counts``; returns the JSON record."""
    from fire_tpu_torch.device import resolve_device
    from fire_tpu_torch.pipeline.batch_engine import _bucket_ladder
    from fire_tpu_torch.train.scenes import make_identities

    device = resolve_device(device)
    results = {"faces_per_frame": [], "ms_per_frame": [], "detected_per_frame": []}
    with tempfile.TemporaryDirectory(prefix="fire_crowd_") as storage:
        fr, bse, rng = setup_crowd(storage, device, rows, engine_cfg)
        try:
            idents = make_identities(32, seed=0)
            for n in counts:
                frames = [s[0].astype(np.uint8) for s in crowd_scenes(rng, idents, n, hw)]
                ms, tracked = measure(bse, stage(frames, batch, device), trials)
                results["faces_per_frame"].append(n)
                results["ms_per_frame"].append(round(ms, 3))
                results["detected_per_frame"].append(round(tracked, 2))
                log(f"[crowd] {n:3d} faces/frame: {ms:.3f} ms/frame (tracked/frame {tracked:.1f})")
        finally:
            fr.close()
    results["bucket_ladder"] = list(_bucket_ladder(batch * ENCODE_K, None))
    results["batch"] = batch
    return results


def main(argv=None) -> int:
    ap = parser("tools/bench_crowd.py on the port: step cost against faces per frame")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--hw", type=int, nargs=2, default=(720, 1280))
    ap.add_argument("--counts", type=int, nargs="+", default=(1, 4, 16, 48, 96))
    ap.add_argument("--tiny", action="store_true",
                    help="small frames, gallery and trials at float32: a CPU smoke of the "
                         "tool itself (numbers are meaningless)")
    args = ap.parse_args(argv)
    if args.tiny:
        from fire_tpu_torch.config import EngineConfig

        kw = dict(TINY, engine_cfg=EngineConfig(**TINY_ENGINE))
    else:
        kw = dict(batch=args.batch, trials=args.trials, hw=tuple(args.hw), counts=args.counts)
    print_result(run(args.device, **kw), args.device)
    return 0
