"""End-to-end pipeline evaluation on a rendered ground-truth video
(counterpart of ``fire_tpu.eval_e2e``: ``score_video``, ``run_matrix``
and ``main``).

The whole stack (detection → SORT tracking → FaceNet encoding → gallery
match through K1 → unknown enrolment) runs on a synthetic video of known
moving identities (:func:`fire_tpu_torch.train.scenes.scene_video`) and
is scored:

* **detection recall / precision** of emitted boxes against GT at
  IoU ≥ 0.5;
* **identity consistency**: each GT identity should map to one stable
  system label (majority-label agreement of every matched emission);
* **identity separation**: distinct GT identities must not share a
  label.

Where OpenCV is installed the video is written to an XVID file and read
back, as in JAX, so the scored frames are the decoded ones.  Without it
(the card's machine) the rendered frames are scored directly, through
:class:`~fire_tpu_torch.pipeline.stream.FrameSequenceCapture`.

    python -m fire_tpu_torch.eval_e2e --trained_detector W --trained E [--batch_size 64]
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Union

import numpy as np


def _iou(a, b) -> float:
    iw = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return float(inter / union) if union > 0 else 0.0


def _capture(video: Union[str, Sequence[np.ndarray]]):
    from fire_tpu_torch.pipeline.stream import FrameSequenceCapture
    from fire_tpu_torch.utils import imageio

    return imageio.open_video(video) if isinstance(video, str) else FrameSequenceCapture(video)


def score_video(fr, video: Union[str, Sequence[np.ndarray]], gt, iou_thresh: float = 0.5,
                batch_size: int = 0, encode_k: int = 8) -> Dict[str, float]:
    """Run ``fr`` over the video (a file path, or its BGR uint8 frames)
    and score against the per-frame GT ``[(boxes (N, 4), ident_keys)]``.
    ``batch_size`` > 0 runs the batched device pipeline, 0 the per-frame
    one.  ``encode_k`` must cover the densest frame (faces beyond it are
    truncated to the top-k by score)."""
    emissions: List[List[dict]] = []
    cap = _capture(video)
    if batch_size > 0:
        from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine, stream_results
        from fire_tpu_torch.pipeline.stream import PrefetchReader

        bse = BatchStreamEngine(fr.engine, fr.gallery, fr.cfg,
                                detection_interval=max(fr.detection_interval, 1),
                                encode_k=encode_k)
        reader = PrefetchReader(cap)
        batch = []
        for frame in reader.frames():
            batch.append(frame)
            if len(batch) == batch_size:
                emissions.extend(stream_results(fr, bse.process_batch(np.stack(batch))))
                batch = []
        if batch:
            pad = batch + [batch[-1]] * (batch_size - len(batch))
            res = bse.process_batch(np.stack(pad))
            emissions.extend(list(stream_results(fr, res))[: len(batch)])
        reader.close()
    else:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            emissions.append(fr.recognize_faces(frame))
    cap.release()

    n = min(len(emissions), len(gt))
    tp = fp = fn = 0
    votes: Dict[object, Counter] = defaultdict(Counter)  # gt ident -> labels
    matched_pairs = []
    for f in range(n):
        gt_boxes, gt_ids = gt[f]
        used = [False] * len(gt_boxes)
        for det in emissions[f]:
            db = det["bbox"]
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
                votes[gt_ids[best]][det["label"]] += 1
                matched_pairs.append((gt_ids[best], det["label"]))
            else:
                fp += 1
        fn += used.count(False)

    majority = {gid: c.most_common(1)[0][0] for gid, c in votes.items() if c}
    agree = sum(1 for gid, lbl in matched_pairs if majority.get(gid) == lbl)
    labels_used = set(majority.values())
    return {
        "frames": n,
        "det_recall": tp / max(tp + fn, 1),
        "det_precision": tp / max(tp + fp, 1),
        "id_consistency": agree / max(len(matched_pairs), 1),
        "id_separation": len(labels_used) / max(len(majority), 1),
        "identities": len(majority),
        "distinct_labels": len(labels_used),
        "tp": tp, "fp": fp, "fn": fn,
    }


def render_video(tmp: str, name: str, identities, hw, n_frames: int, face_px: int, seed: int):
    """``(video, gt)`` for :func:`score_video`: an XVID file under
    ``tmp`` where OpenCV is installed (as JAX scores it), else the
    rendered frames."""
    import os

    from fire_tpu_torch.train.scenes import render_scene_video, scene_video
    from fire_tpu_torch.utils import imageio

    if imageio.has_cv2():
        video = os.path.join(tmp, name)
        gt = render_scene_video(video, identities, hw=hw, n_frames=n_frames,
                                face_px=face_px, seed=seed)
        return video, gt
    frames, gt = [], []
    for frame, boxes, ids in scene_video(identities, hw=hw, n_frames=n_frames,
                                         face_px=face_px, seed=seed):
        frames.append(frame)
        gt.append((boxes, ids))
    return frames, gt


def run_matrix(args) -> None:
    """The accuracy matrix: every detector slot × detection_interval
    {1, 3} × ``--seeds`` seeds on rendered GT videos, through the batched
    pipeline with the committed trained weights.  One JSON row per combo
    to stdout as results land, then a markdown table on stderr."""
    import os
    import sys
    import tempfile
    import time

    from fire_tpu_torch.config import EngineConfig
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.train.scenes import make_identities

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wdir = os.path.join(repo, "weights_trained")
    slot_cfg = {
        "yunet": {"det": os.path.join(wdir, "yunet_synth.msgpack"), "engine": {}},
        "retinaface": {"det": os.path.join(wdir, "retinaface_synth.msgpack"),
                       "engine": {"retinaface_size": (512, 512)}},
        "mediapipe": {"det": os.path.join(wdir, "blazeface_synth.msgpack"),
                      "engine": {"blazeface_size": (args.blazeface_size or 192,
                                                    args.blazeface_size or 192)}},
    }
    # the committed mediapipe weights' file name carries its operating point
    bf192 = os.path.join(wdir, "blazeface192_synth.msgpack")
    if os.path.exists(bf192):
        slot_cfg["mediapipe"]["det"] = bf192
    elif not args.blazeface_size:
        slot_cfg["mediapipe"]["engine"] = {"blazeface_size": (128, 128)}
    enc_w = args.trained or os.path.join(wdir, "facenet512_synth.msgpack")

    batch = args.batch_size or 48
    batch = ((batch + 5) // 6) * 6  # divisible by both intervals {1, 3}
    # the mediapipe slot is a short-range detector: it scores a close-range
    # video (fewer, larger faces)
    close_slots = {"mediapipe"}
    rows = []
    for seed in range(args.seed_start, args.seeds):
        tmp = tempfile.mkdtemp(prefix=f"fire_e2e_m{seed}_")
        scenarios = {}  # name -> (video, gt, n_ids, face_px)
        if any(s not in close_slots for s in args.slots):
            video, gt = render_video(tmp, "gt.avi", make_identities(args.identities, seed=seed + 50),
                                     (args.height, args.width), args.frames, args.face_px, seed)
            scenarios["far"] = (video, gt, args.identities, args.face_px)
        if any(s in close_slots for s in args.slots):
            n_close = min(args.mediapipe_identities, args.identities)
            videoc, gtc = render_video(tmp, "gt_close.avi", make_identities(n_close, seed=seed + 50),
                                       (args.height, args.width), args.frames,
                                       args.mediapipe_face_px, seed)
            scenarios["close"] = (videoc, gtc, n_close, args.mediapipe_face_px)
        print(f"[matrix] seed {seed}: rendered {sorted(scenarios)} "
              f"({args.frames}f {args.width}x{args.height})", file=sys.stderr, flush=True)
        for slot in args.slots:
            sc = slot_cfg[slot]
            video, gt, n_ids, face_px = scenarios["close" if slot in close_slots else "far"]
            for interval in (1, 3):
                fr = FaceRecognition(
                    detector_type=slot, encoder_model_type=args.encoder,
                    similarity_threshold=args.similarity_threshold,
                    unknown_trigger_count=args.unknown_trigger_count,
                    detection_interval=interval, enable_logging=False,
                    storage_root=os.path.join(tmp, f"storage_{slot}_{interval}"),
                    weights_dir=None, trained_detector=sc["det"], trained_encoder=enc_w,
                    engine_cfg=EngineConfig(**sc["engine"]) if sc["engine"] else None,
                    device=args.device)
                t_row = time.time()
                m = score_video(fr, video, gt, batch_size=batch, encode_k=max(8, n_ids))
                fr.close()
                m.update({"slot": slot, "interval": interval, "seed": seed, "ids": n_ids,
                          "face_px": face_px, "row_s": round(time.time() - t_row, 1)})
                rows.append(m)
                print(json.dumps(m), flush=True)

    print("\n| slot | interval | seed | ids | face px | det recall | "
          "det precision | id consistency | id separation |", file=sys.stderr)
    print("|---|---|---|---|---|---|---|---|---|", file=sys.stderr)
    for m in rows:
        print(f"| {m['slot']} | {m['interval']} | {m['seed']} | {m['ids']} | {m['face_px']} | "
              f"{m['det_recall']:.3f} | {m['det_precision']:.3f} | "
              f"{m['id_consistency']:.3f} | {m['id_separation']:.3f} |", file=sys.stderr)


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(description="FIRE-TPU end-to-end accuracy (PyTorch port)")
    ap.add_argument("--trained_detector", default=None)
    ap.add_argument("--trained", default=None, help="trained encoder msgpack")
    ap.add_argument("--identities", type=int, default=4)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--face_px", type=int, default=140)
    ap.add_argument("--batch_size", type=int, default=0)
    ap.add_argument("--detection_interval", type=int, default=1)
    ap.add_argument("--detector", default="yunet")
    ap.add_argument("--retinaface_size", type=int, default=None,
                    help="RetinaFace input size (512 for the committed weights; default 1024)")
    ap.add_argument("--encoder", default="512", choices=["128", "512"])
    ap.add_argument("--video", default=None,
                    help="accepted for the JAX package's flag set; the video is always rendered")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--similarity_threshold", type=float, default=0.7,
                    help="accept/dedup threshold (reference wiring: 0.7)")
    ap.add_argument("--align_video", action="store_true",
                    help="landmark-aligned crops in the video loop (per-frame path)")
    ap.add_argument("--unknown_trigger_count", type=int, default=1,
                    help="frames of evidence averaged before enrolling (reference CLI wiring: 1)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--blazeface_size", type=int, default=None,
                    help="mediapipe-slot input px (192 = trained default, 128 = published)")
    ap.add_argument("--matrix", action="store_true",
                    help="run the accuracy matrix: every slot x detection_interval {1,3} x "
                         "--seeds seeds, committed weights, batched pipeline")
    ap.add_argument("--seeds", type=int, default=3, help="matrix mode: number of seeds")
    ap.add_argument("--seed_start", type=int, default=0, help="matrix mode: first seed")
    ap.add_argument("--mediapipe_face_px", type=int, default=480,
                    help="matrix mode: face size of the mediapipe slot's close-range video")
    ap.add_argument("--mediapipe_identities", type=int, default=4,
                    help="matrix mode: identities on the close-range video")
    ap.add_argument("--slots", nargs="+", default=["yunet", "retinaface", "mediapipe"],
                    help="matrix mode: detector slots to sweep")
    return ap


def main(argv=None) -> None:
    """``python -m fire_tpu_torch.eval_e2e --trained_detector W [...]``:
    render a GT video, drive the full ``FaceRecognition`` stack, print
    one JSON line of metrics."""
    import os
    import tempfile

    from fire_tpu_torch.config import EngineConfig
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.train.scenes import make_identities

    args = build_parser().parse_args(argv)
    if args.matrix:
        return run_matrix(args)

    tmp = tempfile.mkdtemp(prefix="fire_e2e_")
    video, gt = render_video(tmp, "gt.avi", make_identities(args.identities, seed=args.seed + 50),
                             (args.height, args.width), args.frames, args.face_px, args.seed)
    size_kw = {}
    if args.retinaface_size:
        size_kw["retinaface_size"] = (args.retinaface_size, args.retinaface_size)
    if args.blazeface_size:
        size_kw["blazeface_size"] = (args.blazeface_size, args.blazeface_size)
    fr = FaceRecognition(
        detector_type=args.detector, align_video=args.align_video,
        encoder_model_type=args.encoder, similarity_threshold=args.similarity_threshold,
        unknown_trigger_count=args.unknown_trigger_count,
        detection_interval=args.detection_interval, enable_logging=False,
        storage_root=os.path.join(tmp, "storage"), weights_dir=None,
        trained_detector=args.trained_detector, trained_encoder=args.trained,
        engine_cfg=EngineConfig(**size_kw) if size_kw else None, device=args.device)
    metrics = score_video(fr, video, gt, batch_size=args.batch_size)
    fr.close()
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
