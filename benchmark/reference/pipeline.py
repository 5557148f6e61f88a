"""The plain reference of what the timed path computes, in float32 with
TF32 off: the letterbox, the configuration's detector with its decode
and a greedy NMS, the crop of a face box to ``encode_px``, the
configuration's encoder with L2 normalisation, and the gallery's top-1
by cosine similarity.  The networks, their input conventions, decodes
and NMS conventions are their files' (:mod:`reference.nets`).

It imports nothing of the program and takes nothing the program made:
the frames and the gallery rows are the benchmark's, the weights are
read from the configuration's weight files (trained, or seeded by the
benchmark) by :mod:`reference.msgpack`, and the resampling weights,
anchors and normalisation are worked out here again.  With
``quant="fp8"`` every convolution and linear layer reads its input
and weight rounded to float8 e4m3 (a per-tensor scale), and
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


def crop_boxes(frame01: torch.Tensor, boxes_xywh: torch.Tensor,
               out_hw: Tuple[int, int]) -> torch.Tensor:
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
    """The configuration's detector and encoder from its weight files,
    on ``device``, in float32 (``quant=None``) or in the control's
    float8 (``quant="fp8"``)."""

    def __init__(self, cfg: dict, root: str, device, quant: Optional[str] = None):
        strict_f32()
        self.cfg, self.device = cfg, torch.device(device)
        self.quant = fp8 if quant == "fp8" else None
        self.det_net = nets.network(cfg["detector"])
        self.enc_net = nets.network(cfg["encoder"])
        self.det = self._load(self.det_net, "detector", cfg["detector_weights"], root)
        self.enc = self._load(self.enc_net, "encoder", cfg["encoder_weights"], root)

    def _load(self, network, role: str, rel: str, root: str):
        if network.ROLE != role:
            raise ValueError(f"{network.__name__} is a {network.ROLE}, not a {role}")
        net = network.build()
        net.load_state_dict(msgpack.state_dict(msgpack.read(os.path.join(root, rel)),
                                               network.UNIT_BN_SCALE))
        net = net.to(self.device).eval()
        nets.set_quant(net, self.quant)
        return net

    @staticmethod
    def _channels(x: torch.Tensor, network) -> torch.Tensor:
        """``x`` (BGR, channels last) in the network's colour order."""
        return x.flip(-1) if network.CHANNELS == "rgb" else x

    @torch.no_grad()
    def detect(self, frame_u8: np.ndarray, threshold: Optional[float] = None
               ) -> Dict[str, np.ndarray]:
        """One (H, W, 3) uint8 BGR frame -> ``{"boxes": (N, 4) xywh,
        "scores": (N,)}`` in source pixels (float64), after the
        configuration's threshold (or ``threshold``) and NMS."""
        c, dn = self.cfg, self.det_net
        frame = torch.from_numpy(frame_u8).to(self.device).float()
        size = tuple(c["input_px"])
        canvas, scale = letterbox(frame, size)
        x = self._channels(canvas / dn.SCALE, dn)
        boxes, scores = dn.candidates(self.det(x[None]), size)
        boxes = boxes / scale
        live = scores > (c["det_threshold"] if threshold is None else threshold)
        idx = np.nonzero(live)[0]
        keep = idx[greedy_nms(boxes[idx], scores[idx], c["nms_threshold"], c["max_faces"],
                              **dn.NMS)]
        xyxy = boxes[keep]
        return {"boxes": np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1),
                "scores": scores[keep]}

    @torch.no_grad()
    def embed(self, frame_u8: np.ndarray, boxes_xywh: np.ndarray) -> np.ndarray:
        """L2-normalised embeddings (K, ``embedding_dim``) float64 of the
        crops of ``boxes_xywh`` to ``encode_px`` from one uint8 BGR
        frame."""
        if len(boxes_xywh) == 0:
            return np.zeros((0, self.cfg["embedding_dim"]))
        frame = torch.from_numpy(frame_u8).to(self.device).float() / self.enc_net.SCALE
        crops = crop_boxes(frame, torch.as_tensor(np.asarray(boxes_xywh, np.float32),
                                                  device=self.device),
                           tuple(self.cfg["encode_px"]))
        e = self.enc(self._channels(crops, self.enc_net)).double()
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
