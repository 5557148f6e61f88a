"""Detector scoring (counterpart of ``fire_tpu.train.detect``:
``detection_pr`` and ``_iou``; the detector trainers of that module are
not ported yet)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def detection_pr(detect_fn, scenes, iou_thresh: float = 0.5) -> Dict[str, float]:
    """Precision / recall of ``detect_fn(img) -> [{'bbox': [x,y,w,h]}]``
    against GT scenes ``[(img, boxes (N,4), lms)]`` at IoU ≥
    ``iou_thresh``, plus the mean IoU of matched pairs and the mean
    landmark error (when the detections carry 'landmarks')."""
    tp = fp = fn = 0
    ious: List[float] = []
    lm_err: List[float] = []
    for scene in scenes:
        img, gt_boxes, gt_lms = scene[0], scene[1], scene[2]
        dets = detect_fn(img)
        used = np.zeros(len(gt_boxes), bool)
        for d in dets:
            db = np.asarray(d["bbox"], np.float32)
            best, best_iou = -1, 0.0
            for gi in range(len(gt_boxes)):
                if used[gi]:
                    continue
                iou = _iou(db, gt_boxes[gi])
                if iou > best_iou:
                    best, best_iou = gi, iou
            if best >= 0 and best_iou >= iou_thresh:
                used[best] = True
                tp += 1
                ious.append(best_iou)
                if "landmarks" in d and len(gt_lms) > best:
                    dl = np.asarray(d["landmarks"], np.float32).reshape(5, 2)
                    size = np.sqrt(gt_boxes[best][2] * gt_boxes[best][3])
                    lm_err.append(
                        float(np.linalg.norm(dl - gt_lms[best], axis=1).mean() / max(size, 1)))
            else:
                fp += 1
        fn += int((~used).sum())
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / max(precision + recall, 1e-9),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "mean_lm_err": float(np.mean(lm_err)) if lm_err else -1.0,
        "tp": tp, "fp": fp, "fn": fn,
    }


def _iou(a, b) -> float:
    iw = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return float(inter / union) if union > 0 else 0.0
