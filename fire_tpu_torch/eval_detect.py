"""Held-out detector evaluation through the production path
(counterpart of ``fire_tpu.eval_detect``).

``DeviceEngine.detect_faces`` (letterbox → CNN → decode → NMS at the
reference's confidence thresholds) scores any detector slot on freshly
rendered exact-GT scenes and prints one JSON line: precision, recall,
F1, mean IoU and landmark error.

    python -m fire_tpu_torch.eval_detect --detector yunet \\
        --trained_detector weights_trained/yunet_synth.msgpack [--device cpu]
"""

from __future__ import annotations

import json

# per-slot face-size defaults of the matching trainers
FACE_PX = {"mediapipe": (140, 480), "blazeface": (140, 480),
           "yunet": (24, 192), "retinaface": (40, 360)}


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(description="FIRE-TPU held-out detector eval (PyTorch port)")
    ap.add_argument("--detector", default="yunet",
                    choices=["yunet", "retinaface", "mediapipe", "blazeface"])
    ap.add_argument("--trained_detector", default=None,
                    help="detector msgpack; omitted = whatever the engine probes "
                         "(reference ONNX or random init)")
    ap.add_argument("--scenes", type=int, default=64)
    ap.add_argument("--identities", type=int, default=200)
    ap.add_argument("--scene_hw", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--face_px", type=int, nargs=2, default=None,
                    help="face size range in source px (default: the "
                         "matching trainer's default per slot)")
    ap.add_argument("--max_faces", type=int, default=2)
    ap.add_argument("--retinaface_size", type=int, default=None)
    ap.add_argument("--blazeface_size", type=int, default=None,
                    help="mediapipe-slot input px (128 published / 192 trained default)")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap


def evaluate(args, engine=None) -> dict:
    """The JSON record of one run; ``engine`` replaces the one the
    arguments describe."""
    import numpy as np

    from fire_tpu_torch.config import EngineConfig, RecognizerConfig
    from fire_tpu_torch.pipeline.engine import DeviceEngine
    from fire_tpu_torch.train.detect import detection_pr
    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    if engine is None:
        size_kw = {}
        if args.retinaface_size:
            size_kw["retinaface_size"] = (args.retinaface_size, args.retinaface_size)
        if args.blazeface_size:
            size_kw["blazeface_size"] = (args.blazeface_size, args.blazeface_size)
        engine_kw = {"engine": EngineConfig(**size_kw)} if size_kw else {}
        cfg = RecognizerConfig(detector_type=args.detector, weights_dir=None,
                               **engine_kw).with_embedding_dim()
        engine = DeviceEngine(cfg, device=args.device)
        if args.trained_detector:
            engine.load_trained_detector(args.trained_detector)
    face_px = tuple(args.face_px) if args.face_px else FACE_PX[args.detector]
    idents = make_identities(args.identities, seed=args.seed)
    rng = np.random.default_rng(args.seed + 31337)
    scenes = [compose_scene(rng, idents, hw=tuple(args.scene_hw),
                            n_faces=(1, args.max_faces), face_px=face_px)
              for _ in range(args.scenes)]
    pr = detection_pr(engine.detect_faces, scenes, iou_thresh=args.iou)
    pr["detector"] = args.detector
    pr["weights"] = engine.weight_source["detector"]
    return pr


def main(argv=None) -> None:
    print(json.dumps(evaluate(build_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
