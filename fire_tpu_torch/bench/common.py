"""What the bench subcommands share: the headline workload's setup
(``bench.py:175-224``), the pipelined frames/s loop (``bench.py:128-140``),
the percentile summary (``bench.py:305-311``), timing helpers, the forward
MAC count and the card's published peaks.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16
# FLOP/s, and float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS = os.path.join(REPO, "weights_trained")
# ``--tiny``'s device graphs: a CPU smoke of a tool, in float32
TINY_ENGINE = dict(detect_size=(160, 160), encode_size=(96, 96), compute_dtype="float32")

_T0 = time.time()


def log(msg: str) -> None:
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the card)")
    return ap


def print_result(record: dict, device) -> None:
    """On the card the ``nvidia-smi`` line, then the one JSON line; K1's
    launches in this process go to stderr."""
    from fire_tpu_torch.ops import cosine_top1 as k1

    log(f"K1 launches in this run: {k1.launches}")
    if torch.device(device).type == "cuda":
        print(nvidia_smi_line())
    print(json.dumps(record), flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def best_ms(fn, device, trials: int, warmup: int = 1) -> float:
    """Best of ``trials`` calls of ``fn`` after ``warmup`` more, each
    waited for: CUDA events on the card, the host clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    sync(device)
    best = float("inf")
    for _ in range(trials):
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """``n`` standard-normal rows of width ``d``, L2-normalised (float32)."""
    g = rng.standard_normal((n, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    return g


def headline_draws(rows: int = 99_900, dim: int = 512, scenes: int = 8,
                   hw=(1080, 1920), face_px=(180, 360)):
    """The headline's data, drawn as ``bench.py:201-222`` draws it from one
    ``default_rng(0)``: the gallery rows first, then the rendered 1-face
    scenes (``compose_scene`` tuples: image, boxes, landmarks)."""
    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    rng = np.random.default_rng(0)
    gal = unit_rows(rng, rows, dim)
    idents = make_identities(8, seed=0)
    drawn = [compose_scene(rng, idents, hw=tuple(hw), n_faces=(1, 1), face_px=tuple(face_px))
             for _ in range(scenes)]
    return gal, drawn


def setup_headline(storage: str, device=None, rows: int = 99_900, scenes: int = 8,
                   hw=(1080, 1920), face_px=(180, 360), engine_cfg=None):
    """``bench.py:175-224``: ``FaceRecognition`` with YuNet and FaceNet-512,
    threshold 0.7, trigger 1, detection every frame, the Hungarian
    tracker, the committed trained weights, ``rows`` gallery rows and a
    compacted snapshot, then ``scenes`` rendered 1-face frames.  Returns
    ``(recognizer, frames)``.  ``engine_cfg`` shrinks the device graphs
    for a CPU run."""
    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition

    fr = FaceRecognition(
        detector_type="yunet", encoder_model_type="512", similarity_threshold=0.7,
        unknown_trigger_count=1, detection_interval=1, enable_logging=False,
        storage_root=storage, tracker_cfg=TrackerConfig(assignment="hungarian"),
        engine_cfg=engine_cfg, device=device)
    fr.engine.load_trained_detector(os.path.join(WEIGHTS, "yunet_synth.msgpack"))
    fr.engine.load_trained_encoder(os.path.join(WEIGHTS, "facenet512_synth.msgpack"))
    gal, drawn = headline_draws(rows, fr.embedding_dim, scenes, hw, face_px)
    fr.gallery.load_rows((i + 1, f"person_{i}", gal[i].tobytes()) for i in range(gal.shape[0]))
    fr.gallery.save(compact=True)
    frames = [d[0].astype(np.uint8) for d in drawn]
    log(f"{scenes} rendered 1-face {hw[0]}x{hw[1]} scenes ready")
    return fr, frames


def stage(frames, batch: int, device) -> torch.Tensor:
    """``batch`` frames (cycling through ``frames``) stacked on ``device``."""
    out = torch.from_numpy(np.stack([frames[i % len(frames)] for i in range(batch)])).to(device)
    sync(device)
    return out


def pipelined_fps(bse, fr, batch_dev, n_steps: int, trials: int) -> list:
    """``bench.py:128-140``: timed submit/collect loop with one batch in
    flight, every result through ``stream_results``; frames/s per trial."""
    from fire_tpu_torch.pipeline.batch_engine import stream_results

    b = batch_dev.shape[0]
    fps = []
    for _ in range(trials):
        t0 = time.perf_counter()
        pending = bse.submit(batch_dev)
        for _ in range(n_steps - 1):
            nxt = bse.submit(batch_dev)
            list(stream_results(fr, bse.collect(pending)))
            pending = nxt
        list(stream_results(fr, bse.collect(pending)))
        fps.append(n_steps * b / (time.perf_counter() - t0))
    return fps


def spread(values) -> dict:
    """``bench.py:305-311``: best, median, quartiles and min (two or more values)."""
    q = statistics.quantiles(values, n=4)
    return {"best": round(max(values), 1), "median": round(statistics.median(values), 1),
            "p25": round(q[0], 1), "p75": round(q[2], 1), "min": round(min(values), 1)}


def forward_macs(model, *args, **kwargs) -> int:
    """Multiply-accumulates of one forward, counted from the shapes: each
    convolution's output elements × (input channels / groups) × kernel
    area, each Linear's outputs × input features."""
    total = [0]

    def conv(mod, inp, out):
        total[0] += out.numel() * (mod.in_channels // mod.groups) * (
            mod.kernel_size[0] * mod.kernel_size[1])

    def dense(mod, inp, out):
        total[0] += out.numel() * mod.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else dense)
             for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return total[0]
