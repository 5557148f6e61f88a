"""The plain reference of what the timed path computes, in float32 with
TF32 off: the letterbox, the detector with its decode and a greedy NMS,
the crop of a face box to 160 x 160, FaceNet-512 with L2
normalisation, and the gallery's top-1 by cosine similarity.

It imports nothing of the program and takes nothing the program made:
the frames and the gallery rows are the benchmark's, the weights are
read from the trained files by :mod:`reference.msgpack`, and the
resampling weights, anchors and normalisation are worked out here
again.  With ``quant="fp8"`` every convolution and linear layer reads
its input and weight rounded to float8 e4m3 (a per-tensor scale), and
the gallery product rows and queries likewise: the control, one
precision below the configuration's bfloat16.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import msgpack, nets

FP8_MAX = 448.0  # largest finite float8 e4m3

# RetinaFace base anchors (xyxy) per stride, two per cell.
RETINA_ANCHORS = {
    32: ((-248.0, -248.0, 263.0, 263.0), (-120.0, -120.0, 135.0, 135.0)),
    16: ((-56.0, -56.0, 71.0, 71.0), (-24.0, -24.0, 39.0, 39.0)),
    8: ((-8.0, -8.0, 23.0, 23.0), (0.0, 0.0, 15.0, 15.0)),
}


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps
    its largest magnitude to 448, returned in float32."""
    s = torch.clamp(x.detach().abs().amax().float(), min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def strict_f32() -> None:
    """Float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def letterbox(frame: torch.Tensor, out_hw: Tuple[int, int]) -> Tuple[torch.Tensor, float]:
    """(H, W, 3) float frame -> ((oh, ow, 3) canvas, scale): an
    aspect-preserving half-pixel bilinear resize (no antialias), zero
    padded at the bottom and right."""
    h, w = frame.shape[:2]
    oh, ow = out_hw
    scale = min(oh / h, ow / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = F.interpolate(frame.permute(2, 0, 1)[None], size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=False)[0].permute(1, 2, 0)
    return F.pad(x, (0, 0, 0, ow - nw, 0, oh - nh)), float(scale)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, thr: float, max_out: int,
               plus_one: bool, suppress_equal: bool) -> np.ndarray:
    """Indices kept by greedy NMS over xyxy ``boxes`` in descending score
    order (ties: the lower index first)."""
    order = np.argsort(-scores, kind="stable")
    off = 1.0 if plus_one else 0.0
    area = (boxes[:, 2] - boxes[:, 0] + off) * (boxes[:, 3] - boxes[:, 1] + off)
    keep, dead = [], np.zeros(len(boxes), bool)
    for i in order:
        if dead[i]:
            continue
        keep.append(i)
        if len(keep) == max_out:
            break
        iw = np.clip(np.minimum(boxes[i, 2], boxes[:, 2]) - np.maximum(boxes[i, 0], boxes[:, 0])
                     + off, 0, None)
        ih = np.clip(np.minimum(boxes[i, 3], boxes[:, 3]) - np.maximum(boxes[i, 1], boxes[:, 1])
                     + off, 0, None)
        inter = iw * ih
        union = area[i] + area - inter
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0)
        dead |= iou >= thr if suppress_equal else iou > thr
    return np.asarray(keep, np.int64)


def _yunet_candidates(heads) -> Tuple[np.ndarray, np.ndarray]:
    """YuNet's anchor-free decode: score sqrt(cls * obj), centre (cell +
    offset) * stride, size exp(pred) * stride."""
    boxes, scores = [], []
    for stride, (cls, obj, box, _kps) in heads.items():
        cls, obj, box = (t[0].double().cpu().numpy() for t in (cls, obj, box))
        h, w = cls.shape[:2]
        cols, rows = np.arange(w)[None, :], np.arange(h)[:, None]
        cx = (cols + box[..., 0]) * stride
        cy = (rows + box[..., 1]) * stride
        bw, bh = np.exp(box[..., 2]) * stride, np.exp(box[..., 3]) * stride
        boxes.append(np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                              -1).reshape(-1, 4))
        scores.append(np.sqrt(np.clip(cls[..., 0] * obj[..., 0], 0, 1)).reshape(-1))
    return np.concatenate(boxes), np.concatenate(scores)


def _retina_candidates(heads, im_hw) -> Tuple[np.ndarray, np.ndarray]:
    """RetinaFace's anchor decode (legacy +1 widths), clipped to the
    network input, strides 32, 16, 8 in that order."""
    boxes, scores = [], []
    for stride in (32, 16, 8):
        prob, bbox = (t[0].double().cpu().numpy() for t in heads[stride][:2])
        h, w, a = prob.shape
        base = np.asarray(RETINA_ANCHORS[stride], np.float64)
        xs, ys = np.meshgrid(np.arange(w) * stride, np.arange(h) * stride)
        shift = np.stack([xs, ys, xs, ys], -1)[:, :, None, :]
        anc = (shift + base[None, None]).reshape(-1, 4)
        d = bbox.reshape(-1, 4)
        aw, ah = anc[:, 2] - anc[:, 0] + 1.0, anc[:, 3] - anc[:, 1] + 1.0
        acx, acy = anc[:, 0] + 0.5 * (aw - 1.0), anc[:, 1] + 0.5 * (ah - 1.0)
        px, py = d[:, 0] * aw + acx, d[:, 1] * ah + acy
        pw, ph = np.exp(d[:, 2]) * aw, np.exp(d[:, 3]) * ah
        b = np.stack([px - 0.5 * (pw - 1.0), py - 0.5 * (ph - 1.0),
                      px + 0.5 * (pw - 1.0), py + 0.5 * (ph - 1.0)], -1)
        b[:, 0::2] = np.clip(b[:, 0::2], 0, im_hw[1] - 1.0)
        b[:, 1::2] = np.clip(b[:, 1::2], 0, im_hw[0] - 1.0)
        boxes.append(b)
        scores.append(prob.reshape(-1))
    return np.concatenate(boxes), np.concatenate(scores)


def crop_boxes(frame01: torch.Tensor, boxes_xywh: torch.Tensor,
               out_hw: Tuple[int, int] = (160, 160)) -> torch.Tensor:
    """Bilinear crops of K xywh boxes from one (H, W, C) frame: sample
    points at half-pixel centres across each box, held inside the box
    and the frame, as two dense products.  Returns (K, oh, ow, C)."""
    h, w = frame01.shape[:2]
    oh, ow = out_hw
    b = boxes_xywh.float()
    x, y = b[:, 0:1], b[:, 1:2]
    bw, bh = torch.clamp(b[:, 2:3], min=1.0), torch.clamp(b[:, 3:4], min=1.0)
    dev = b.device
    ys = y + (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * bh / oh - 0.5
    xs = x + (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * bw / ow - 0.5
    ys = torch.clamp(torch.minimum(torch.maximum(ys, y), y + bh - 1.0), 0.0, h - 1.0)
    xs = torch.clamp(torch.minimum(torch.maximum(xs, x), x + bw - 1.0), 0.0, w - 1.0)
    wy = torch.clamp(1.0 - (ys[..., None] - torch.arange(h, device=dev)).abs(), min=0.0)
    wx = torch.clamp(1.0 - (xs[..., None] - torch.arange(w, device=dev)).abs(), min=0.0)
    rows = torch.einsum("kyh,hwc->kywc", wy, frame01)
    return torch.einsum("kxw,kywc->kyxc", wx, rows)


class Reference:
    """The configuration's detector and encoder from the trained files,
    on ``device``, in float32 (``quant=None``) or in the control's
    float8 (``quant="fp8"``)."""

    def __init__(self, cfg: dict, root: str, device, quant: Optional[str] = None):
        strict_f32()
        self.cfg, self.device = cfg, torch.device(device)
        self.quant = fp8 if quant == "fp8" else None
        self.det_kind = cfg["detector"]
        self.det = self._load(self.det_kind, cfg["detector_weights"], root, False)
        self.enc = self._load("facenet512", cfg["encoder_weights"], root, True)

    def _load(self, kind: str, rel: str, root: str, unit_bn_scale: bool):
        net = nets.build(kind)
        net.load_state_dict(msgpack.state_dict(msgpack.read(os.path.join(root, rel)),
                                               unit_bn_scale))
        net = net.to(self.device).eval()
        nets.set_quant(net, self.quant)
        return net

    @torch.no_grad()
    def detect(self, frame_u8: np.ndarray, threshold: Optional[float] = None
               ) -> Dict[str, np.ndarray]:
        """One (H, W, 3) uint8 BGR frame -> ``{"boxes": (N, 4) xywh,
        "scores": (N,)}`` in source pixels (float64), after the
        configuration's threshold (or ``threshold``) and NMS."""
        c = self.cfg
        frame = torch.from_numpy(frame_u8).to(self.device).float()
        size = tuple(c["input_px"])
        canvas, scale = letterbox(frame, size)
        if self.det_kind == "yunet":
            boxes, scores = _yunet_candidates(self.det((canvas / 255.0)[None]))
            plus_one = suppress_equal = False
            boxes = boxes / scale
        else:
            boxes, scores = _retina_candidates(self.det(canvas.flip(-1)[None]), size)
            plus_one = suppress_equal = True
            boxes = boxes / scale
        live = scores > (c["det_threshold"] if threshold is None else threshold)
        idx = np.nonzero(live)[0]
        keep = idx[greedy_nms(boxes[idx], scores[idx], c["nms_threshold"], c["max_faces"],
                              plus_one, suppress_equal)]
        xyxy = boxes[keep]
        return {"boxes": np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1),
                "scores": scores[keep]}

    @torch.no_grad()
    def embed(self, frame_u8: np.ndarray, boxes_xywh: np.ndarray) -> np.ndarray:
        """L2-normalised embeddings (K, 512) float64 of the crops of
        ``boxes_xywh`` from one uint8 BGR frame."""
        if len(boxes_xywh) == 0:
            return np.zeros((0, 512))
        frame = torch.from_numpy(frame_u8).to(self.device).float() / 255.0
        crops = crop_boxes(frame, torch.as_tensor(np.asarray(boxes_xywh, np.float32),
                                                  device=self.device))
        e = self.enc(crops.flip(-1)).double()
        return F.normalize(e, dim=1).cpu().numpy()

    def set_gallery(self, rows: np.ndarray, added) -> None:
        """The gallery's rows on the device: the benchmark's ``rows``,
        then the ``added`` ones in the order they were appended."""
        g = np.concatenate([rows, np.stack(added)]) if len(added) else rows
        self.gallery = torch.as_tensor(np.asarray(g, np.float32), device=self.device)
        self.gallery_q = (self.quant(self.gallery) if self.quant is not None
                          else self.gallery.double())

    def sims(self, queries: np.ndarray, n_rows: int) -> np.ndarray:
        """Cosine similarities (Q, n_rows) of unit ``queries`` against the
        gallery's first ``n_rows`` rows: float64, or the control's float8
        operands (one scale for the whole gallery)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        g = self.gallery_q[:n_rows]
        if self.quant is not None:
            return (self.quant(q) @ g.T).double().cpu().numpy()
        return (q.double() @ g.T).cpu().numpy()
