"""RetinaFace training on synthetic scenes (counterpart of
``fire_tpu.train.detect_retina``).

Targets are the exact inverse of the production decode
(:func:`fire_tpu_torch.models.retinaface.decode_retinaface`, with the
legacy ``+1`` anchor widths):

* each (stride, anchor) has a fixed size: 512 / 256 at stride 32, 128 /
  64 at 16, 32 / 16 at 8.  A face matches the anchor shapes within 0.6
  octaves of its sqrt-area;
* among those, positives are anchors whose centre lies in the face's
  central half-box, with a half-cell floor; the nearest face (by size
  first, then distance) owns the anchor;
* ``dx = (cx_gt − cx_a)/w_a``, ``dw = log(w_gt/w_a)`` and the landmark
  analog;
* anchors of nearly the right size (within 1.0 octave) whose centre
  lies inside a face but that are not positive are ignored; the rest
  train as negatives.

The class head is trained through its softmax face probability (the
forward's output contract), clipped to [1e-6, 1 − 1e-6], with OHEM BCE
(default) or focal BCE.  The step samples an on-device scene pool and
feeds the network what the engine feeds the RetinaFace slot: the bf16
letterbox, BGR → RGB, raw pixels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from fire_tpu_torch.ops.anchors import RETINAFACE_ANCHORS, RETINAFACE_STRIDES
from fire_tpu_torch.train.detect import focal_bce, gather_faces, smooth_l1
from fire_tpu_torch.train.detect_blaze import deploy_transform, ohem_bce


def _anchor_geometry():
    """Per stride: anchor widths, heights and centre offsets in a cell
    (xyxy tables with the legacy +1 width)."""
    geo = {}
    for st in RETINAFACE_STRIDES:
        base = RETINAFACE_ANCHORS[st]
        w = base[:, 2] - base[:, 0] + 1.0  # (A,)
        h = base[:, 3] - base[:, 1] + 1.0
        cx = base[:, 0] + 0.5 * (w - 1.0)
        cy = base[:, 1] + 0.5 * (h - 1.0)
        geo[st] = (w, h, cx, cy)
    return geo


_GEO = _anchor_geometry()
# octave distance beyond which an anchor shape is not assigned a face
_SIZE_BAND = 0.6


def retina_targets(boxes: torch.Tensor, lms: torch.Tensor, valid: torch.Tensor,
                   hw: Tuple[int, int]):
    """Batched targets for the three FPN heads.  ``boxes`` (B, F, 4) xywh
    px, ``lms`` (B, F, 5, 2), ``valid`` (B, F); ``hw`` divisible by 32.
    Returns ``{stride: (cls_t (B,h,w,A), box_t (B,h,w,A,4), kps_t
    (B,h,w,A,10), wgt (B,h,w,A))}``."""
    H, W = hw
    dev = boxes.device
    x, y, bw, bh = boxes.unbind(-1)
    cx, cy = x + bw / 2.0, y + bh / 2.0
    size = torch.sqrt(torch.clamp(bw, min=1e-3) * torch.clamp(bh, min=1e-3))
    out = {}
    for st in RETINAFACE_STRIDES:
        gh, gw = H // st, W // st
        aw, ah, acx, acy = (torch.from_numpy(v).to(dev) for v in _GEO[st])
        # anchor centres (gh, gw, A)
        gx = (torch.arange(gw, dtype=torch.float32, device=dev)[None, :, None] * st + acx
              ).expand(gh, gw, -1)
        gy = (torch.arange(gh, dtype=torch.float32, device=dev)[:, None, None] * st + acy
              ).expand(gh, gw, -1)
        a_size = torch.sqrt(aw * ah)

        oct_d = torch.abs(torch.log2(size[..., None] / a_size))  # (B, F, A)
        size_ok = (oct_d <= _SIZE_BAND) & valid[..., None]
        # (B, F, gh, gw, A) geometry
        dx = torch.abs(gx - cx[..., None, None, None])
        dy = torch.abs(gy - cy[..., None, None, None])
        tol_x = torch.clamp(bw / 4.0, min=st / 2.0)[..., None, None, None]
        tol_y = torch.clamp(bh / 4.0, min=st / 2.0)[..., None, None, None]
        pos = (dx <= tol_x) & (dy <= tol_y) & size_ok[:, :, None, None, :]
        size_near = (oct_d <= _SIZE_BAND + 0.4) & valid[..., None]
        inbox = ((dx <= (bw / 2.0)[..., None, None, None])
                 & (dy <= (bh / 2.0)[..., None, None, None])
                 & size_near[:, :, None, None, :])

        d2 = dx * dx + dy * dy + oct_d[:, :, None, None, :] * 1e4
        owner = torch.argmin(torch.where(pos, d2, torch.inf), dim=1)  # (B, gh, gw, A)
        any_pos = pos.any(dim=1)
        cls_t = any_pos.float()
        wgt = torch.where(inbox.any(dim=1) & ~any_pos, 0.0, 1.0)

        def g(v):  # (B, F, ...) → (B, gh, gw, A, ...) by owner
            return gather_faces(v, owner)

        t_dx = (g(cx) - gx) / aw
        t_dy = (g(cy) - gy) / ah
        t_dw = torch.log(torch.clamp(g(bw), min=1e-3) / aw)
        t_dh = torch.log(torch.clamp(g(bh), min=1e-3) / ah)
        box_t = torch.stack([t_dx, t_dy, t_dw, t_dh], dim=-1) * cls_t[..., None]
        k = g(lms)  # (B, gh, gw, A, 5, 2)
        t_kx = (k[..., 0] - gx[..., None]) / aw[:, None]
        t_ky = (k[..., 1] - gy[..., None]) / ah[:, None]
        kps_t = torch.stack([t_kx, t_ky], dim=-1).reshape(*cls_t.shape, 10) * cls_t[..., None]
        out[st] = (cls_t, box_t, kps_t, wgt)
    return out


def retina_detection_loss(heads, targets, box_weight: float = 2.0, kps_weight: float = 0.5,
                          alpha: float = 0.75, gamma: float = 2.0, cls_loss: str = "ohem",
                          neg_pos_ratio: float = 7.0):
    """Classification + smooth-L1 delta losses over the heads ``{stride:
    (prob (B,h,w,A), bbox (B,h,w,4A), lmk (B,h,w,10A))}``.  The score
    loss runs over every stride's anchors together: ``"ohem"``
    (:func:`~fire_tpu_torch.train.detect_blaze.ohem_bce`) or ``"focal"``."""
    total_pos = 1e-6
    box_l = kps_l = 0.0
    probs, ts, ws = [], [], []
    for st, (prob, bbox, lmk) in heads.items():
        cls_t, box_t, kps_t, wgt = targets[st]
        b, h, w, A = cls_t.shape
        bbox = bbox.reshape(b, h, w, A, 4)
        lmk = lmk.reshape(b, h, w, A, 10)
        total_pos = total_pos + cls_t.sum()
        probs.append(torch.clamp(prob, 1e-6, 1.0 - 1e-6).reshape(b, -1))
        ts.append(cls_t.reshape(b, -1))
        ws.append(wgt.reshape(b, -1))
        box_l = box_l + (smooth_l1(bbox - box_t).sum(-1) * cls_t).sum()
        kps_l = kps_l + (smooth_l1(lmk - kps_t).sum(-1) * cls_t).sum()
    p, t, wgt = torch.cat(probs, dim=1), torch.cat(ts, dim=1), torch.cat(ws, dim=1)
    if cls_loss == "ohem":
        cls_l = ohem_bce(p, t, wgt, neg_pos_ratio)
    else:
        cls_l = (focal_bce(p, t, alpha, gamma) * wgt).sum()
    loss = (cls_l + box_weight * box_l + kps_weight * kps_l) / total_pos
    return loss, {"cls": cls_l / total_pos, "box": box_l / total_pos,
                  "kps": kps_l / total_pos, "n_pos": total_pos}


def make_retina_pool_train_step(model, optimizer, hw: Tuple[int, int],
                                loss_kwargs: Dict | None = None, compute_dtype=None):
    """``step((params, batch_stats, opt_state), pool_imgs u8, pool_boxes,
    pool_lms, pool_valid, idx) → (state, loss, metrics)`` on an
    on-device scene pool; the scenes go through
    :func:`~fire_tpu_torch.train.detect_blaze.deploy_transform` (RGB, raw
    pixels, after it), the GT through its scale."""
    from fire_tpu_torch.ops.image import bgr_to_rgb
    from fire_tpu_torch.train.trainer import compute_context, optimizer_step

    def step(state, pool_imgs, pool_boxes, pool_lms, pool_valid, idx):
        canvas, scale = deploy_transform(pool_imgs[idx], hw)
        images = bgr_to_rgb(canvas)
        targets = retina_targets(pool_boxes[idx] * scale, pool_lms[idx] * scale,
                                 pool_valid[idx], hw)
        params, batch_stats, opt_state = state
        with compute_context(images.device, compute_dtype):
            heads = model(images, train=True)
        loss, metrics = retina_detection_loss(heads, targets, **(loss_kwargs or {}))
        opt_state = optimizer_step(optimizer, params, opt_state, loss)
        return ((params, batch_stats, opt_state), loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    return step


def engine_config(hw: Tuple[int, int]):
    """The held-out evaluation's engine: these weights at their train-time
    input size (``EngineConfig.retinaface_size``)."""
    from fire_tpu_torch.config import EngineConfig, RecognizerConfig

    return RecognizerConfig(
        detector_type="retinaface", weights_dir=None,
        engine=EngineConfig(retinaface_size=tuple(hw)),
    ).with_embedding_dim()


# ----------------------------------------------------------------- CLI ---


def main(argv=None):
    """``python -m fire_tpu_torch.train.detect_retina``: train the
    deployable RetinaFace and write detector variables for
    ``detector_type='retinaface'`` (every ``--save_every`` steps and at
    the end, atomically).  Returns the held-out P/R (None without
    ``--eval_scenes``)."""
    import argparse
    import logging

    ap = argparse.ArgumentParser(description="FIRE RetinaFace training (PyTorch)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512,
                    help="train-time network input (÷32); also the recommended deploy "
                         "retinaface_size for these weights")
    ap.add_argument("--scene_hw", type=int, nargs=2, default=(480, 640),
                    help="compose resolution; the step letterboxes to --size exactly as "
                         "the deployed engine does")
    ap.add_argument("--identities", type=int, default=200)
    ap.add_argument("--cls_loss", choices=("ohem", "focal"), default="ohem",
                    help="score loss: hard-negative-mined BCE (default) or focal BCE")
    ap.add_argument("--neg_pos_ratio", type=float, default=7.0,
                    help="OHEM negatives kept per positive (min 32/image)")
    ap.add_argument("--box_weight", type=float, default=2.0,
                    help="regression-loss weight; raise for a localization-focused fine-tune")
    ap.add_argument("--init_from", default=None,
                    help="msgpack of a previous run to warm-start from (fine-tune)")
    ap.add_argument("--alpha", type=float, default=0.75,
                    help="focal positive weight (focal mode only)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--pool", type=int, default=512)
    ap.add_argument("--gen_threads", type=int, default=6)
    ap.add_argument("--max_faces", type=int, default=3)
    ap.add_argument("--face_px", type=int, nargs=2, default=(40, 360),
                    help="face size in SOURCE px")
    ap.add_argument("--out", default="trained_retinaface.msgpack")
    ap.add_argument("--save_every", type=int, default=500,
                    help="periodic checkpoint interval (steps); the final weights always "
                         "overwrite --out at the end of the schedule")
    ap.add_argument("--eval_scenes", type=int, default=48)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device_pool", type=int, default=384)
    ap.add_argument("--refresh_block", type=int, default=32)
    ap.add_argument("--refresh_every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("fire_tpu_torch.train.detect_retina")

    from fire_tpu_torch.device import resolve_device
    from fire_tpu_torch.models.retinaface import RetinaFace
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.detect import (ScenePool, eval_scenes, held_out_pr, pad_gt,
                                             train_on_pool, warm_start_variables,
                                             write_variables)
    from fire_tpu_torch.train.scenes import compose_scene, make_identities
    from fire_tpu_torch.train.trainer import cli_compute_dtype, model_batch_stats
    from fire_tpu_torch.weights import flax_shapes, load_flax, materialize

    device = resolve_device(args.device)
    idents = make_identities(args.identities, seed=args.seed)
    hw = (args.size, args.size)
    scene_hw = tuple(args.scene_hw)

    def gen(rng):
        img, boxes, lms = compose_scene(rng, idents, hw=scene_hw, n_faces=(1, args.max_faces),
                                        face_px=tuple(args.face_px))
        return (img.astype(np.uint8), *pad_gt(boxes, lms, args.max_faces))

    def save(tag):
        write_variables(model, args.out)
        log.info("trained RetinaFace variables written to %s (%s)", args.out, tag)

    def on_step(state, step):
        if args.save_every and step % args.save_every == 0:
            save(f"step {step}")

    model = RetinaFace().to(device)
    variables = materialize(flax_shapes(model), seed=args.seed)
    if args.init_from:
        variables = warm_start_variables(variables, args.init_from)
        log.info("warm-started from %s", args.init_from)
    load_flax(model, variables)
    optimizer = optim.chain(
        optim.clip_by_global_norm(5.0),
        optim.adamw(optim.cosine_decay_schedule(args.lr, args.steps, 0.05)),
    )
    params = list(model.parameters())
    step_fn = make_retina_pool_train_step(
        model, optimizer, hw,
        loss_kwargs={"cls_loss": args.cls_loss, "neg_pos_ratio": args.neg_pos_ratio,
                     "alpha": args.alpha, "box_weight": args.box_weight},
        compute_dtype=cli_compute_dtype(device))

    pool = ScenePool(gen, size=args.pool, threads=args.gen_threads, seed=args.seed)
    try:
        train_on_pool(pool, step_fn, (params, model_batch_stats(model), optimizer.init(params)),
                      args, device, log, ("cls", "box", "kps"), on_step=on_step)
    finally:
        pool.stop()
    save("final")

    if not args.eval_scenes:
        return None
    scenes = eval_scenes(idents, args.eval_scenes, args.seed, scene_hw, args.max_faces,
                         args.face_px)
    pr = held_out_pr(engine_config(hw), args.out, scenes, device)
    log.info("held-out detection @%dx%d (production path, retinaface_size=%s): %s",
             scene_hw[1], scene_hw[0], hw, pr)
    return pr


if __name__ == "__main__":
    main()
