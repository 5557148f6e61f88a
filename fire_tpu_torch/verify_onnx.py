"""ONNX parity gate: ``python -m fire_tpu_torch.verify_onnx <file>``
(counterpart of ``fire_tpu.verify_onnx``, with the same roles, gates and
JSON line, plus ``--device``).

Per role, the file's weights imported onto the port's module are held
against the file's own graph run by the ONNX executor
(:class:`fire_tpu_torch.models.onnx_exec.OnnxModel`):

* ``encoder`` (FaceNet 128 / 512): the same random NHWC [0, 1] inputs
  through both; gate: cosine distance ≤ 1e-3.
* ``yunet`` and ``blazeface``: two engines on the file, one imported, one
  executing it, through the whole ``detect`` (letterbox → CNN → decode →
  NMS) at a floor confidence; gate: every matched box pair at IoU ≥ 0.99
  and score within 1e-3.
* ``retinaface``: the reference export has no layer-order mapping (the
  engine runs it through the executor), so the gate is that it runs and
  decodes to finite detections.

Exit code 0 with ``"ok": true`` on the JSON line means parity holds.
Both sides run in float32; on the card TF32 is turned off for the run.
"""

from __future__ import annotations

import json
import sys


def _iou_xywh(a, b) -> float:
    iw = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = float(a[2] * a[3] + b[2] * b[3] - inter)
    return float(inter / union) if union > 0 else (1.0 if inter == 0 else 0.0)


def detect_role(graph) -> str:
    """The role, from the graph's output signature."""
    outs = set(graph.outputs)
    if {"classifier_8", "regressor_8"} & outs:
        return "blazeface"
    if len(graph.outputs) == 9:
        return "retinaface"
    if len(graph.outputs) == 1:
        return "encoder"
    return "yunet"


def verify_encoder(graph, dim: int, depths, stem_width: int, n: int, seed: int,
                   device="cuda") -> dict:
    import numpy as np
    import torch

    from fire_tpu_torch.models.facenet import FaceNet
    from fire_tpu_torch.models.onnx_exec import OnnxModel
    from fire_tpu_torch.models.onnx_import import assign_facenet
    from fire_tpu_torch.weights import flax_shapes, from_flax_facenet, load_into, materialize

    model = FaceNet(embed_dim=dim, depths=tuple(depths), stem_width=stem_width).eval()
    variables = materialize(flax_shapes(model, unit_bn_scale=True), seed=0)
    params, stats = assign_facenet(variables["params"], variables.get("batch_stats", {}),
                                   graph, depths=tuple(depths))
    load_into(model, from_flax_facenet({"params": params, "batch_stats": stats}))
    model.to(device)
    onnx_model = OnnxModel(graph, device=device)

    rng = np.random.default_rng(seed)
    x = rng.random((n, 160, 160, 3)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x).to(device)).cpu().numpy()
    got = np.concatenate([onnx_model(x[i : i + 1])[0].cpu().numpy() for i in range(n)])
    cos = np.sum((want / np.linalg.norm(want, axis=1, keepdims=True))
                 * (got / np.linalg.norm(got, axis=1, keepdims=True)), axis=1)
    max_dist = float((1.0 - cos).max())
    return {"role": "encoder", "embed_dim": int(want.shape[1]),
            "max_cosine_distance": max_dist,
            "gate": "<=1e-3 cosine distance (SURVEY §2.3)",
            "ok": bool(max_dist <= 1e-3)}


def _detector_engines(path: str, role: str, width, device="cuda"):
    """Two engines on the same file, the import against the executor,
    both in float32 so the comparison isolates the port, not bf16."""
    import dataclasses

    from fire_tpu_torch.config import EngineConfig, RecognizerConfig
    from fire_tpu_torch.models.facenet import tiny_facenet
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    det_type = "mediapipe" if role == "blazeface" else role
    kw = dict(compute_dtype="float32", strict_f32_preprocess=True)
    if role == "yunet" and width:
        kw["detect_size"] = (64, 64)
    # floor thresholds, so both paths emit their top boxes whatever the
    # content (real weights find nothing in random frames)
    cfg = dataclasses.replace(
        RecognizerConfig(detector_type=det_type, weights_dir=None, engine=EngineConfig(**kw)),
        yunet_conf_threshold=1e-3, blazeface_conf_threshold=1e-3, retinaface_threshold=1e-3)

    def build():
        detector = None
        if role == "yunet" and width:
            from fire_tpu_torch.models.yunet import YuNet

            detector = YuNet(width=width)
        return DeviceEngine(cfg, device=device, detector=detector,
                            encoder=tiny_facenet(cfg.embedding_dim))

    imp, ex = build(), build()
    if role == "yunet":
        imp.load_yunet_onnx_weights(path)
        ex._use_onnx_yunet(path)
    elif role == "blazeface":
        imp.load_blazeface_onnx_weights(path)
        ex._use_onnx_blazeface(path)
    else:
        raise ValueError(role)
    return imp, ex


def verify_detector(path: str, role: str, width, n: int, seed: int, device="cuda") -> dict:
    import numpy as np

    imp, ex = _detector_engines(path, role, width, device)
    rng = np.random.default_rng(seed)
    worst_iou, worst_score = 1.0, 0.0
    pairs = 0
    for _ in range(n):
        frame = rng.integers(0, 255, (96, 128, 3), np.uint8)
        da, db = imp.detect(frame), ex.detect(frame)
        ma, mb = da.mask.cpu().numpy(), db.mask.cpu().numpy()
        ba, sa = da.boxes_xywh.cpu().numpy()[ma], da.scores.cpu().numpy()[ma]
        bb, sb = db.boxes_xywh.cpu().numpy()[mb], db.scores.cpu().numpy()[mb]
        for i in range(min(len(ba), len(bb))):
            ious = [_iou_xywh(ba[i], bb[j]) for j in range(len(bb))]
            j = int(np.argmax(ious))
            pairs += 1
            worst_iou = min(worst_iou, ious[j])
            worst_score = max(worst_score, abs(float(sa[i] - sb[j])))
    ok = pairs > 0 and worst_iou >= 0.99 and worst_score <= 1e-3
    return {"role": role, "matched_pairs": pairs,
            "min_box_iou": round(worst_iou, 6),
            "max_score_delta": round(worst_score, 8),
            "gate": "IoU>=0.99 & score delta<=1e-3 on every matched box",
            "ok": bool(ok)}


def verify_retinaface(path: str, seed: int, device="cuda") -> dict:
    import numpy as np

    from fire_tpu_torch.config import RecognizerConfig
    from fire_tpu_torch.models.facenet import tiny_facenet
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    cfg = RecognizerConfig(detector_type="retinaface", weights_dir=None)
    eng = DeviceEngine(cfg, device=device, encoder=tiny_facenet(cfg.embedding_dim))
    eng._use_onnx_retinaface(path)
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 255, (480, 640, 3), np.uint8)
    dets = eng.detect(frame)
    finite = bool(np.isfinite(dets.boxes_xywh.cpu().numpy()).all())
    return {"role": "retinaface",
            "note": "no layer-order mapping for the TF-converted export; the engine runs "
                    "this file through the exact executor, so the gate is exact execution",
            "decode_finite": finite, "ok": finite}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m fire_tpu_torch.verify_onnx",
        description="FIRE ONNX parity gate (SURVEY §2.3: <=1e-3), PyTorch port")
    ap.add_argument("onnx_path")
    ap.add_argument("--role", default="auto",
                    choices=["auto", "encoder", "yunet", "blazeface", "retinaface"])
    ap.add_argument("--dim", type=int, default=512, help="encoder embedding dim (128 or 512)")
    ap.add_argument("--depths", type=int, nargs=3, default=(5, 10, 5),
                    help="encoder Inception-ResNet depths (tests use 1 1 1)")
    ap.add_argument("--stem_width", type=int, default=32)
    ap.add_argument("--width", type=int, default=0,
                    help="YuNet base width (0 = full 64; tests use 8)")
    ap.add_argument("--n", type=int, default=4, help="random inputs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on ('cuda', or 'cpu' explicitly)")
    args = ap.parse_args(argv)

    import torch

    from fire_tpu_torch.device import resolve_device
    from fire_tpu_torch.models.onnx_import import read_onnx

    device = resolve_device(args.device)
    graph = read_onnx(args.onnx_path)  # raises on Git-LFS stubs, loudly
    role = args.role if args.role != "auto" else detect_role(graph)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        if role == "encoder":
            out = verify_encoder(graph, args.dim, args.depths, args.stem_width, args.n,
                                 args.seed, device)
        elif role == "retinaface":
            out = verify_retinaface(args.onnx_path, args.seed, device)
        else:
            out = verify_detector(args.onnx_path, role, args.width or None, args.n, args.seed,
                                  device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["file"] = args.onnx_path
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
