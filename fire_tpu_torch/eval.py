"""Identification evaluation: verification ROC / AUC over embeddings
(counterpart of ``fire_tpu.eval``).

Given labeled embeddings, or a directory of per-identity face folders run
through the engine, compute the all-pairs same/different-identity
verification ROC AUC for the cosine and the Euclidean metric.  Images are
read by :mod:`fire_tpu_torch.utils.imageio` (BMP, PPM and PNG without
OpenCV) and resized by the port's area resize.

    python -m fire_tpu_torch.eval --data DIR/test [--device cpu]
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from fire_tpu_torch.train.scenes import resize_area_u8
from fire_tpu_torch.utils import imageio

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def pair_scores(embeddings: np.ndarray, labels: Sequence,
                metric: str = "cosine") -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs scores and same-identity ground truth: ``(scores
    (N·(N−1)/2,), is_same (N·(N−1)/2,) bool)``; a higher score means
    "more likely the same" (Euclidean distances are negated)."""
    emb = np.asarray(embeddings, np.float32)
    if metric == "cosine":
        norm = np.linalg.norm(emb, axis=1, keepdims=True)
        emb = emb / np.maximum(norm, 1e-12)
        sims = emb @ emb.T
    elif metric == "euclidean":
        d2 = ((emb[:, None, :] - emb[None, :, :]) ** 2).sum(-1)
        sims = -np.sqrt(np.maximum(d2, 0.0))
    else:
        raise ValueError(f"unknown metric {metric}")
    labels = np.asarray(labels)
    iu = np.triu_indices(len(labels), k=1)
    return sims[iu], labels[:, None][iu[0], 0] == labels[iu[1]]


def roc_auc(scores: np.ndarray, is_same: np.ndarray) -> float:
    """AUC by the Mann-Whitney U statistic (rank-based, tie-aware)."""
    scores = np.asarray(scores, np.float64)
    pos = is_same.astype(bool)
    n_pos = int(pos.sum())
    n_neg = int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("need both positive and negative pairs")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, len(scores) + 1, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):  # average ranks over ties
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def identification_auc(embeddings: np.ndarray, labels: Sequence,
                       metrics: Sequence[str] = ("cosine", "euclidean")) -> Dict[str, float]:
    """AUC per similarity metric."""
    out = {}
    for m in metrics:
        s, y = pair_scores(embeddings, labels, m)
        out[m] = roc_auc(s, y)
    return out


def _images(root: str):
    """``(identity, BGR uint8 image)`` for every decodable image of
    ``root/<identity>/``, in sorted order."""
    for ident in sorted(os.listdir(root)):
        d = os.path.join(root, ident)
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            if not fname.lower().endswith(_IMAGE_EXTS):
                continue
            img = imageio.imread(os.path.join(d, fname))
            if img is not None:
                yield ident, img


def encode_directory(engine, root: str, size=(160, 160)):
    """Encode every ``root/<identity>/*`` image directly (no detection):
    the images are taken as pre-cropped faces.  Returns ``(embeddings
    (N, D), labels)``."""
    embs: List[np.ndarray] = []
    labels: List[str] = []
    batch, names = [], []

    def flush():
        if batch:
            embs.extend(engine.encode_faces(np.stack(batch)))
            labels.extend(names)
            batch.clear(), names.clear()

    for ident, img in _images(root):
        if names and names[-1] != ident:
            flush()
        if img.shape[:2] != tuple(size):
            img = resize_area_u8(img, tuple(size))
        batch.append(img[..., ::-1].astype(np.float32) / 255.0)  # BGR→RGB [0,1]
        names.append(ident)
    flush()
    if not embs:
        raise ValueError(
            f"no decodable images found under {root!r}: expected the "
            "identity-folder layout <root>/<identity>/*.{jpg,png,bmp}")
    return np.stack(embs), labels


def evaluate_directory(engine, root: str, align: bool = True) -> Dict[str, float]:
    """``root/<identity>/*.{jpg,png,bmp}`` → detect, align and encode
    every image with the live engine → AUC."""
    embs: List[np.ndarray] = []
    labels: List[str] = []
    for ident, img in _images(root):
        faces = engine.extract_faces(img, align=align)
        if not faces:
            continue
        emb = engine.encode_faces(np.stack(faces[:1]))[0]
        if np.linalg.norm(emb) == 0:
            continue
        embs.append(emb)
        labels.append(ident)
    if len(set(labels)) < 2:
        raise ValueError("need at least two identities with detected faces")
    return identification_auc(np.stack(embs), labels)


def main(argv=None) -> None:
    """``python -m fire_tpu_torch.eval --data DIR``: verification AUC of
    the engine on an identity-folder dataset; ``--trained`` loads encoder
    variables first.  With ``--detect`` every image goes through
    detect → align → encode; by default the images are encoded directly."""
    import argparse
    import json

    from fire_tpu_torch.config import RecognizerConfig
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    ap = argparse.ArgumentParser(description="FIRE-TPU verification AUC (PyTorch port)")
    ap.add_argument("--data", required=True, help="root: <root>/<identity>/*.png")
    ap.add_argument("--encoder", default="512", choices=["128", "512"])
    ap.add_argument("--detector", default="yunet", choices=["yunet", "retinaface", "mediapipe"])
    ap.add_argument("--trained", default=None, help="encoder variables msgpack")
    ap.add_argument("--detect", action="store_true",
                    help="run detection+alignment instead of direct encode")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = RecognizerConfig(detector_type=args.detector, encoder_model_type=args.encoder,
                           weights_dir=None).with_embedding_dim()
    engine = DeviceEngine(cfg, device=args.device)
    if args.trained:
        engine.load_trained_encoder(args.trained)
    if args.detect:
        aucs, n = evaluate_directory(engine, args.data), None
    else:
        embs, labels = encode_directory(engine, args.data)
        aucs, n = identification_auc(embs, labels), len(labels)
    print(json.dumps({"auc": aucs, "n": n, "trained": bool(args.trained)}))


if __name__ == "__main__":
    main()
