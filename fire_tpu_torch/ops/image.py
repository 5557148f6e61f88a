"""Batched image preprocessing (counterpart of ``fire_tpu.ops.image``).

Images are NHWC / HWC tensors at the public functions, as in JAX;
boxes are pixel ``[x, y, w, h]``.

* ``resize_bilinear`` is ``jax.image.resize(..., "linear",
  antialias=False)`` (``image.py:44``), which equals ``F.interpolate(
  mode="bilinear", align_corners=False, antialias=False)``: half-pixel
  centres, edge clamp.
* The crop resamplers keep the JAX package's bf16 rounding points:
  bf16 operands, float32 accumulation, bf16 intermediates where JAX
  casts them.  A bf16 × bf16 product is exact in float32, so only the
  order of the sums differs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def bgr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """Channel-reverse on the last axis."""
    return x.flip(-1)


rgb_to_bgr = bgr_to_rgb  # involution


def normalize_01(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0, 255] → ``dtype`` [0, 1], divided in ``dtype``."""
    return x.to(dtype) / torch.tensor(255.0, dtype=dtype, device=x.device)


def resize_bilinear(image: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centre bilinear resize of (..., H, W, C), no antialias."""
    *lead, h, w, c = image.shape
    x = image.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_hw[0], out_hw[1], c)


def resize_area(image: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``cv2.INTER_AREA``-style downscale of (..., H, W, C): an exact box
    average for integer factors, antialiased linear resampling otherwise
    (``image.py:47``)."""
    *lead, h, w, c = image.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0 and h >= oh and w >= ow:
        x = image.reshape(*lead, oh, h // oh, ow, w // ow, c)
        return x.mean(dim=(-4, -2))
    x = image.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, oh, ow, c)


def letterbox(image: torch.Tensor, out_hw: Tuple[int, int], pad_value: float = 0.0):
    """Aspect-preserving resize + bottom/right pad of (..., H, W, C).

    Returns ``(canvas, scale)``; ``boxes_in_canvas / scale`` maps
    detections back to source pixels.  ``scale`` is a Python float
    (static per input shape, as in JAX)."""
    h, w = image.shape[-3], image.shape[-2]
    oh, ow = out_hw
    scale = min(oh / h, ow / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_bilinear(image, (nh, nw))
    canvas = F.pad(resized, (0, 0, 0, ow - nw, 0, oh - nh), value=pad_value)
    return canvas, float(scale)


def _crop_coords(box: torch.Tensor, out_hw, img_hw):
    """Half-pixel-centre sample coordinates ``ys`` (K, oh), ``xs``
    (K, ow) for K boxes, clamped to the crop and then to the image."""
    oh, ow = out_hw
    h, w = img_hw
    dev = box.device
    x, y = box[:, 0:1], box[:, 1:2]
    bw = torch.clamp(box[:, 2:3], min=1.0)
    bh = torch.clamp(box[:, 3:4], min=1.0)
    ys = y + (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * bh / oh - 0.5
    xs = x + (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * bw / ow - 0.5
    ys = torch.clamp(torch.minimum(torch.maximum(ys, y), y + bh - 1.0), 0.0, h - 1.0)
    xs = torch.clamp(torch.minimum(torch.maximum(xs, x), x + bw - 1.0), 0.0, w - 1.0)
    return ys, xs


def _tent(coords: torch.Tensor, n: int) -> torch.Tensor:
    """Dense bilinear weights ``relu(1 − |c_i − j|)`` over j < n."""
    j = torch.arange(n, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - j), min=0.0)


def crop_and_resize_mm(image: torch.Tensor, boxes_xywh: torch.Tensor,
                       out_hw: Tuple[int, int] = (160, 160)) -> torch.Tensor:
    """Crop + bilinear resize of K boxes from one (H, W, C) frame as two
    matrix products ``Wy · image · Wxᵀ`` (``image.py:113``).
    Returns (K, oh, ow, C) float32."""
    h, w, c = image.shape
    img = image.to(torch.bfloat16)
    ys, xs = _crop_coords(boxes_xywh.float(), out_hw, (h, w))
    wy, wx = _tent(ys, h), _tent(xs, w)
    # JAX: einsum(bf16, bf16) accumulated in f32, then cast to bf16
    tmp = torch.einsum("kyh,hwc->kywc", wy.to(torch.bfloat16).float(), img.float())
    tmp = tmp.to(torch.bfloat16)
    return torch.einsum("kxw,kywc->kyxc", wx.to(torch.bfloat16).float(), tmp.float())


# Float32 working set of one pass of :func:`crop_and_resize_mm_batched`:
# the frames are taken this many bytes at a time (about 9 frames of 1080p
# with 8 boxes each), where a B = 256 batch of 1080p frames cast whole
# would take 6.4 GB and its first product 7.5 GB more.
CROP_CHUNK_BYTES = 1 << 30


def crop_and_resize_mm_batched(frames: torch.Tensor, boxes_xywh: torch.Tensor,
                               out_hw: Tuple[int, int] = (160, 160),
                               chunk_bytes: int = CROP_CHUNK_BYTES) -> torch.Tensor:
    """:func:`crop_and_resize_mm` over a batch: (n, H, W, C) frames and
    (n, K, 4) boxes, the counterpart of ``jax.vmap(crop_and_resize_mm)``
    with the frame dimension written out.  The same rounding points (bf16
    operands, float32 sums, a bf16 cast after the first product), so each
    frame's crops equal the one-frame call's.  The frames go in chunks of
    at most ``chunk_bytes`` of float32 temporaries (at least one frame).
    Returns (n, K, oh, ow, C) float32."""
    n, h, w, c = frames.shape
    k = boxes_xywh.shape[1]
    oh, ow = out_hw
    per_frame = h * w * c * 6 + k * oh * w * c * 10 + k * oh * ow * c * 4
    step = max(1, chunk_bytes // per_frame)
    ys, xs = _crop_coords(boxes_xywh.reshape(n * k, 4).float(), out_hw, (h, w))
    wy = _tent(ys, h).to(torch.bfloat16).reshape(n, k, oh, h)
    wx = _tent(xs, w).to(torch.bfloat16).reshape(n, k, ow, w)
    outs = []
    for s in range(0, n, step):
        img = frames[s : s + step].to(torch.bfloat16)
        tmp = torch.einsum("nkyh,nhwc->nkywc", wy[s : s + step].float(), img.float())
        tmp = tmp.to(torch.bfloat16)
        outs.append(torch.einsum("nkxw,nkywc->nkyxc", wx[s : s + step].float(), tmp.float()))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _rows_then_cols(rows_src: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, w: int):
    """Finish crops from their gathered bracketing rows
    ``rows_src`` (K, oh, 2, W, C): a bf16 2-point row lerp, then the
    column interpolation as a dense product over W (``image.py:178``)."""
    wy = (ys - torch.floor(ys))[..., None, None].to(torch.bfloat16)
    r16 = rows_src.to(torch.bfloat16)
    rows = r16[:, :, 0] * (1.0 - wy) + r16[:, :, 1] * wy
    return torch.einsum("kxw,kywc->kyxc", _tent(xs, w).to(torch.bfloat16).float(), rows.float())


def crop_and_resize_rows(image: torch.Tensor, boxes_xywh: torch.Tensor,
                         out_hw: Tuple[int, int] = (160, 160)) -> torch.Tensor:
    """Crop + resize of K boxes from one (H, W, C) frame by a gather of
    the bracketing rows and one column product (``image.py:204``).
    Returns (K, oh, ow, C) float32."""
    h, w = image.shape[0], image.shape[1]
    ys, xs = _crop_coords(boxes_xywh.float(), out_hw, (h, w))
    y0i = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y01 = torch.stack([y0i, torch.clamp(y0i + 1, 0, h - 1)], dim=-1)
    return _rows_then_cols(image[y01], ys, xs, w)


def crop_and_resize(image: torch.Tensor, boxes_xywh: torch.Tensor,
                    out_hw: Tuple[int, int] = (160, 160)) -> torch.Tensor:
    """Crop + bilinear resize of K boxes from one (H, W, C) float frame
    by a 4-tap gather (``image.py:286``): half-pixel centres clamped to
    the crop, taps clamped to the image (edge replicate).  Degenerate
    boxes are widened to 1 px.  Returns (K, oh, ow, C)."""
    oh, ow = out_hw
    h, w = image.shape[0], image.shape[1]
    box = boxes_xywh.float()
    dev = box.device
    x, y = box[:, 0:1], box[:, 1:2]
    bw = torch.clamp(box[:, 2:3], min=1.0)
    bh = torch.clamp(box[:, 3:4], min=1.0)
    ys = y + (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * bh / oh - 0.5
    xs = x + (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * bw / ow - 0.5
    ys = torch.minimum(torch.maximum(ys, y), y + bh - 1.0)  # (K, oh)
    xs = torch.minimum(torch.maximum(xs, x), x + bw - 1.0)  # (K, ow)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x0i = torch.clamp(x0.long(), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    ya, yb = y0i[:, :, None], y1i[:, :, None]
    xa, xb = x0i[:, None, :], x1i[:, None, :]
    top = image[ya, xa] * (1.0 - wx) + image[ya, xb] * wx
    bot = image[yb, xa] * (1.0 - wx) + image[yb, xb] * wx
    return top * (1.0 - wy) + bot * wy


def crop_selected_rows(frames: torch.Tensor, frame_idx: torch.Tensor,
                       boxes_xywh: torch.Tensor, out_hw: Tuple[int, int] = (160, 160),
                       chunk: int = 64) -> torch.Tensor:
    """Crop M selected boxes from a (B, H, W, C) frame batch
    (``image.py:233``): only the 2·oh bracketing rows of each crop are
    gathered (``frame_idx`` folds into the row index of the (B·H, W, C)
    view), in ``chunk``-sized slices that bound the gathered-row temp.
    Returns (M, oh, ow, C) float32."""
    b, h, w, c = frames.shape
    m = boxes_xywh.shape[0]
    flat = frames.reshape(b * h, w, c)
    fi_all = frame_idx.long()
    bx_all = boxes_xywh.float()
    outs = []
    for s in range(0, m, chunk):
        fi, bx = fi_all[s : s + chunk], bx_all[s : s + chunk]
        ys, xs = _crop_coords(bx, out_hw, (h, w))
        y0i = torch.clamp(torch.floor(ys).long(), 0, h - 1)
        base = (fi * h)[:, None]
        y01 = torch.stack([base + y0i, base + torch.clamp(y0i + 1, 0, h - 1)], dim=-1)
        rows_src = flat[y01]  # (cs, oh, 2, W, C) source dtype
        outs.append(_rows_then_cols(rows_src, ys, xs, w))
    return torch.cat(outs, dim=0)
