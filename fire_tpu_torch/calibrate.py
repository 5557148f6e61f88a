"""Similarity-threshold calibration for the match / enroll decision
(counterpart of ``fire_tpu.calibrate``).

Through the production path (detect → device crop → FaceNet encode) it
measures the genuine and imposter cosine-similarity distributions on
held-out rendered identities, then sweeps candidate thresholds and
reports FAR (imposter pairs accepted) and FRR (genuine pairs rejected),
the Youden-optimal threshold and a suggested one.

    python -m fire_tpu_torch.calibrate --trained_detector W --trained E [--device cpu]
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

CANDIDATES = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9]


def _best_iou_box(det_boxes: np.ndarray, gt_box: np.ndarray) -> Tuple[int, float]:
    best, best_iou = -1, 0.0
    gx, gy, gw, gh = gt_box
    for i, (x, y, w, h) in enumerate(det_boxes):
        iw = max(0.0, min(x + w, gx + gw) - max(x, gx))
        ih = max(0.0, min(y + h, gy + gh) - max(y, gy))
        inter = iw * ih
        union = w * h + gw * gh - inter
        iou = inter / union if union > 0 else 0.0
        if iou > best_iou:
            best, best_iou = i, iou
    return best, best_iou


def collect_production_embeddings(
    engine,
    n_identities: int = 24,
    views: int = 10,
    seed: int = 777,
    hw: Tuple[int, int] = (480, 640),
    face_px: Tuple[int, int] = (80, 260),
    iou_min: float = 0.4,
) -> Tuple[np.ndarray, List[int]]:
    """``(embeddings, identity labels)`` through the deployed path: each
    view is a fresh single-face scene, the face is located by the
    detector and encoded from the device crop."""
    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    idents = make_identities(n_identities, seed=seed)
    rng = np.random.default_rng(seed + 1)
    embs: List[np.ndarray] = []
    labels: List[int] = []
    for k in range(n_identities):
        got = 0
        attempts = 0
        while got < views and attempts < views * 4:
            attempts += 1
            img, gt_boxes, _ = compose_scene(
                rng, [idents[k]], hw=hw, n_faces=(1, 1), face_px=face_px,
                n_distractors=(0, 2), occlusion_prob=0.0)
            if gt_boxes.shape[0] == 0:
                continue
            det = engine.detect_faces(img)
            if len(det) == 0:
                continue
            det_boxes = np.asarray([d["bbox"] for d in det], np.float32)
            bi, iou = _best_iou_box(det_boxes, gt_boxes[0])
            if bi < 0 or iou < iou_min:
                continue
            emb = engine.encode_boxes(img, det_boxes[bi : bi + 1])[0]
            n = np.linalg.norm(emb)
            if n == 0:
                continue
            embs.append(emb / n)
            labels.append(k)
            got += 1
    if len(set(labels)) < 2:
        raise RuntimeError("calibration needs >=2 identities with detections")
    return np.stack(embs), labels


def sweep(scores: np.ndarray, is_same: np.ndarray,
          candidates: List[float]) -> Dict[str, object]:
    """FAR / FRR at each candidate, distribution statistics and the
    suggested thresholds."""
    gen = np.sort(scores[is_same])
    imp = np.sort(scores[~is_same])
    rows = []
    for th in candidates:
        far = float((imp >= th).mean())
        frr = float((gen < th).mean())
        rows.append({"threshold": th, "far": round(far, 5), "frr": round(frr, 5)})
    # Youden-optimal over a fine grid (max TPR − FPR)
    grid = np.linspace(0.0, 1.0, 1001)
    tpr = 1.0 - np.searchsorted(gen, grid) / max(len(gen), 1)
    fpr = 1.0 - np.searchsorted(imp, grid) / max(len(imp), 1)
    youden = float(grid[int(np.argmax(tpr - fpr))])
    # midpoint of the empirical gap (robust when the distributions separate)
    gap_mid = float((gen[max(int(0.02 * len(gen)) - 1, 0)] + imp[-1]) / 2.0) \
        if gen[0] > imp[-1] else youden
    return {
        "n_genuine": int(len(gen)), "n_imposter": int(len(imp)),
        "genuine": {"p02": round(float(gen[int(0.02 * len(gen))]), 4),
                    "p50": round(float(np.median(gen)), 4),
                    "min": round(float(gen[0]), 4)},
        "imposter": {"p98": round(float(imp[int(0.98 * len(imp)) - 1]), 4),
                     "p50": round(float(np.median(imp)), 4),
                     "max": round(float(imp[-1]), 4)},
        "sweep": rows,
        "youden_threshold": round(youden, 3),
        "suggested_threshold": round(gap_mid if gen[0] > imp[-1] else youden, 3),
    }


def calibrate(engine, n_identities: int = 24, views: int = 10, seed: int = 777) -> dict:
    """The JSON record of ``main``: the sweep over the engine's
    production embeddings."""
    from fire_tpu_torch.eval import pair_scores

    embs, labels = collect_production_embeddings(engine, n_identities=n_identities,
                                                 views=views, seed=seed)
    scores, is_same = pair_scores(embs, labels, "cosine")
    out = sweep(scores, is_same, candidates=CANDIDATES)
    out["reference_threshold"] = 0.7
    return out


def main(argv=None) -> None:
    import argparse
    import dataclasses

    from fire_tpu_torch.config import RecognizerConfig
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    ap = argparse.ArgumentParser(description="fire_tpu threshold calibration (PyTorch port)")
    ap.add_argument("--trained_detector", default=None)
    ap.add_argument("--trained", default=None, help="trained encoder msgpack")
    ap.add_argument("--detector", default="yunet")
    ap.add_argument("--encoder", default="512", choices=["128", "512"])
    ap.add_argument("--identities", type=int, default=24)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--detect_size", type=int, default=None,
                    help="square detector input (speeds up CPU runs)")
    args = ap.parse_args(argv)

    cfg = RecognizerConfig(detector_type=args.detector, encoder_model_type=args.encoder,
                           weights_dir=None).with_embedding_dim()
    if args.detect_size:
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, detect_size=(args.detect_size, args.detect_size)))
    engine = DeviceEngine(cfg, device=args.device)
    if args.trained_detector:
        engine.load_trained_detector(args.trained_detector)
    if args.trained:
        engine.load_trained_encoder(args.trained)
    print(json.dumps(calibrate(engine, args.identities, args.views, args.seed)))


if __name__ == "__main__":
    main()
