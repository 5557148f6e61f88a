"""BlazeFace (MediaPipe slot) training on synthetic scenes (counterpart
of ``fire_tpu.train.detect_blaze``).

* Anchor-relative SSD targets, the exact inverse of
  :func:`fire_tpu_torch.models.blazeface.decode_blazeface`: a positive
  anchor's 16 targets are ``[cx − ax, cy − ay, w, h, kx_i − ax, ky_i −
  ay, …]`` in input pixels.
* An anchor is positive for a face when its centre lies in the face's
  central half-box, with a half-cell floor so the centre cell is always
  positive, on the grid that owns the face's size (stride-8 anchors:
  faces up to 64 px, stride-16: from 48 px).  The nearest such face owns
  it.  A ring just outside the positive tolerance on the owning grid is
  ignored; everything else trains as a negative.
* The model predicts 6 keypoints; kp3's target is the mouth midpoint
  and the two ear slots are masked out of the loss.
* Targets are built on the device from padded GT; the step samples an
  on-device scene pool, pushes each 480×640 scene through the engine's
  own transform (bf16 letterbox, then BGR → RGB and /255: what
  ``DeviceEngine._build_detect`` feeds the BlazeFace slot) and scales
  the GT by the letterbox's scale.
* The score loss is hard-negative-mined BCE (``ohem``, default) or focal
  BCE, from the sigmoid probabilities clipped to [1e-6, 1 − 1e-6].

BlazeFace has no BatchNorm (its BN is folded into the convs): the state
is ``(params, opt_state)``.
"""

from __future__ import annotations

import numpy as np
import torch

from fire_tpu_torch.train.detect import focal_bce, gather_faces, smooth_l1

INPUT_PX = 128


def _cell_px(input_px: int) -> np.ndarray:
    """Anchor cell size in px of the model input: stride-8 anchors
    (2/cell) then stride-16 anchors (6/cell)."""
    g8, g16 = input_px // 8, input_px // 16
    return np.concatenate([np.full(g8 * g8 * 2, 8.0, np.float32),
                           np.full(g16 * g16 * 6, 16.0, np.float32)])


def blaze_targets(boxes: torch.Tensor, lms: torch.Tensor, valid: torch.Tensor,
                  input_px: int = INPUT_PX):
    """Batched SSD targets for the A anchors (896 at 128², 2016 at 192²).

    ``boxes`` (B, F, 4) xywh pixels of the ``input_px``² image, ``lms``
    (B, F, 5, 2), ``valid`` (B, F) bool.  Returns ``(cls_t (B, A), reg_t
    (B, A, 16), wgt (B, A), reg_mask (16,))``."""
    from fire_tpu_torch.models.blazeface import blaze_anchors

    dev = boxes.device
    anc = torch.from_numpy(blaze_anchors(input_px)).to(dev) * input_px  # (A, 2)
    cell = torch.from_numpy(_cell_px(input_px)).to(dev)  # (A,)
    ax, ay = anc[:, 0], anc[:, 1]
    x, y, bw, bh = boxes.unbind(-1)
    cx, cy = x + bw / 2.0, y + bh / 2.0

    dx = torch.abs(ax - cx[..., None])  # (B, F, A)
    dy = torch.abs(ay - cy[..., None])
    tol_x = torch.maximum(bw[..., None] / 4.0, cell / 2.0)
    tol_y = torch.maximum(bh[..., None] / 4.0, cell / 2.0)
    # grid ownership by size: stride 8 up to 64 px, stride 16 from 48 px
    size = torch.maximum(bw, bh)[..., None]
    scale_fit = torch.where(cell <= 8.0, size <= 64.0, size >= 48.0)
    ok = valid[..., None]
    pos = (dx <= tol_x) & (dy <= tol_y) & scale_fit & ok
    ign_x = dx <= torch.minimum(2.0 * tol_x, bw[..., None] / 2.0)
    ign_y = dy <= torch.minimum(2.0 * tol_y, bh[..., None] / 2.0)
    inbox = ign_x & ign_y & scale_fit & ok

    # each anchor's owner: the nearest face centre among faces claiming it
    d2 = torch.where(pos, dx * dx + dy * dy, torch.inf)
    owner = torch.argmin(d2, dim=1)  # (B, A); ties: the first face
    any_pos = pos.any(dim=1)
    cls_t = any_pos.float()
    wgt = torch.where(inbox.any(dim=1) & ~any_pos, 0.0, 1.0)

    def g(v):  # (B, F, ...) → (B, A, ...) by owner
        return gather_faces(v, owner)

    t = torch.stack([g(cx) - ax, g(cy) - ay, g(bw), g(bh)], dim=-1)
    # 6 model keypoints from the 5-point GT: mouth midpoint at kp3, ears zero
    mouth = (lms[..., 3, :] + lms[..., 4, :])[..., None, :] / 2.0
    kp6 = torch.cat([lms[..., :3, :], mouth, torch.zeros_like(lms[..., :2, :])], dim=-2)
    kp = g(kp6) - anc[:, None, :]  # (B, A, 6, 2)
    reg_t = torch.cat([t, kp.reshape(*owner.shape, 12)], dim=-1) * cls_t[..., None]
    reg_mask = torch.tensor([1.0] * 12 + [0.0] * 4, device=dev)
    return cls_t, reg_t, wgt, reg_mask


def ohem_bce(p: torch.Tensor, t: torch.Tensor, wgt: torch.Tensor,
             neg_pos_ratio: float) -> torch.Tensor:
    """BCE on the positives plus the ``max(neg_pos_ratio · n_pos, 32)``
    largest negative terms of each image (rows of (B, N)): a rank mask
    over the descending sort, as JAX's."""
    pos_sum = (-t * torch.log(p) * wgt).sum()
    neg_raw = -(1.0 - t) * torch.log(1.0 - p) * wgt
    neg_sorted = torch.sort(neg_raw, dim=1, descending=True).values
    k = torch.clamp(neg_pos_ratio * (t * wgt).sum(dim=1, keepdim=True), min=32.0)
    ranks = torch.arange(neg_sorted.shape[1], dtype=torch.float32, device=p.device)
    return pos_sum + (neg_sorted * (ranks < k)).sum()


def blaze_detection_loss(scores, regs, targets, box_weight: float = 2.0,
                         kps_weight: float = 0.25, alpha: float = 0.75, gamma: float = 2.0,
                         reg_scale: float = 8.0, cls_loss: str = "ohem",
                         neg_pos_ratio: float = 7.0):
    """Score loss on the anchors plus smooth-L1 regression.  ``scores``
    (B, A) raw logits, ``regs`` (B, A, 16) in input pixels; regression
    differences are divided by ``reg_scale`` px.  ``cls_loss`` is
    ``"ohem"`` (:func:`ohem_bce`) or ``"focal"``."""
    cls_t, reg_t, wgt, reg_mask = targets
    p = torch.clamp(torch.sigmoid(scores), 1e-6, 1.0 - 1e-6)
    if cls_loss == "ohem":
        cls_l = ohem_bce(p, cls_t, wgt, neg_pos_ratio)
    else:
        cls_l = (focal_bce(p, cls_t, alpha, gamma) * wgt).sum()
    sl1 = smooth_l1((regs - reg_t) / reg_scale) * reg_mask
    box_l = (sl1[..., :4].sum(-1) * cls_t).sum()
    kps_l = (sl1[..., 4:].sum(-1) * cls_t).sum()
    n_pos = cls_t.sum() + 1e-6
    loss = (cls_l + box_weight * box_l + kps_weight * kps_l) / n_pos
    return loss, {"cls": cls_l / n_pos, "box": box_l / n_pos, "kps": kps_l / n_pos,
                  "n_pos": n_pos}


def deploy_transform(frames_u8: torch.Tensor, input_hw):
    """The engine's detector input for uint8 BGR frames: the bf16
    letterbox to ``input_hw``, as float32 BGR pixels.  Returns
    ``(canvas, scale)``; frames already at ``input_hw`` pass as they are."""
    from fire_tpu_torch.ops.image import letterbox

    if tuple(frames_u8.shape[1:3]) == tuple(input_hw):
        return frames_u8.float(), 1.0
    canvas, scale = letterbox(frames_u8.to(torch.bfloat16), tuple(input_hw))
    return canvas.float(), scale


def make_blaze_pool_train_step(model, optimizer, loss_kwargs=None, input_px: int = INPUT_PX,
                               compute_dtype=None):
    """``step((params, opt_state), pool_imgs u8, pool_boxes, pool_lms,
    pool_valid, idx) → (state, loss, metrics)`` on an on-device scene
    pool; the scenes go through :func:`deploy_transform` (RGB / 255
    after it), and the GT through its scale."""
    from fire_tpu_torch.ops.image import bgr_to_rgb
    from fire_tpu_torch.train.trainer import compute_context, optimizer_step

    def step(state, pool_imgs, pool_boxes, pool_lms, pool_valid, idx):
        canvas, scale = deploy_transform(pool_imgs[idx], (input_px, input_px))
        images = bgr_to_rgb(canvas) / 255.0
        targets = blaze_targets(pool_boxes[idx] * scale, pool_lms[idx] * scale,
                                pool_valid[idx], input_px)
        params, opt_state = state
        with compute_context(images.device, compute_dtype):
            scores, regs = model(images)
        loss, metrics = blaze_detection_loss(scores, regs, targets, **(loss_kwargs or {}))
        opt_state = optimizer_step(optimizer, params, opt_state, loss)
        return (params, opt_state), loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return step


def engine_config(input_px: int):
    """The engine configuration the held-out evaluation detects with."""
    from fire_tpu_torch.config import EngineConfig, RecognizerConfig

    return RecognizerConfig(
        detector_type="mediapipe", weights_dir=None,
        engine=EngineConfig(blazeface_size=(input_px, input_px)),
    ).with_embedding_dim()


# ----------------------------------------------------------------- CLI ---


def main(argv=None):
    """``python -m fire_tpu_torch.train.detect_blaze``: train the
    deployable BlazeFace and write detector variables for
    ``detector_type='mediapipe'``.  Returns the held-out P/R (None
    without ``--eval_scenes``)."""
    import argparse
    import logging

    ap = argparse.ArgumentParser(description="FIRE BlazeFace training (PyTorch)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
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
    ap.add_argument("--input_px", type=int, default=128,
                    help="model input resolution (multiple of 16): 128 is the published "
                         "short-range contract; 192 (2016 anchors) the trained default")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--pool", type=int, default=1024)
    ap.add_argument("--gen_threads", type=int, default=6)
    ap.add_argument("--max_faces", type=int, default=2)
    ap.add_argument("--scene_hw", type=int, nargs=2, default=(480, 640),
                    help="compose resolution; the step letterboxes to --input_px exactly "
                         "as the deployed engine does")
    ap.add_argument("--face_px", type=int, nargs=2, default=(140, 480),
                    help="face size in SOURCE px")
    ap.add_argument("--out", default="trained_blazeface.msgpack")
    ap.add_argument("--eval_scenes", type=int, default=64)
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device_pool", type=int, default=512,
                    help="scenes resident on the device (a 480×640 scene is ~0.9 MB)")
    ap.add_argument("--refresh_block", type=int, default=32)
    ap.add_argument("--refresh_every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("fire_tpu_torch.train.detect_blaze")

    from fire_tpu_torch.device import resolve_device
    from fire_tpu_torch.models.blazeface import BlazeFace
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.detect import (ScenePool, eval_scenes, held_out_pr, pad_gt,
                                             train_on_pool, warm_start_variables,
                                             write_variables)
    from fire_tpu_torch.train.scenes import compose_scene, make_identities
    from fire_tpu_torch.train.trainer import cli_compute_dtype
    from fire_tpu_torch.weights import flax_shapes, load_flax, materialize

    device = resolve_device(args.device)
    idents = make_identities(args.identities, seed=args.seed)
    hw = tuple(args.scene_hw)

    def gen(rng):
        img, boxes, lms = compose_scene(rng, idents, hw=hw, n_faces=(1, args.max_faces),
                                        face_px=tuple(args.face_px))
        return (img.astype(np.uint8), *pad_gt(boxes, lms, args.max_faces))

    model = BlazeFace().to(device)
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
    step_fn = make_blaze_pool_train_step(
        model, optimizer,
        loss_kwargs={"cls_loss": args.cls_loss, "neg_pos_ratio": args.neg_pos_ratio,
                     "alpha": args.alpha, "box_weight": args.box_weight},
        input_px=args.input_px, compute_dtype=cli_compute_dtype(device))

    pool = ScenePool(gen, size=args.pool, threads=args.gen_threads, seed=args.seed)
    try:
        train_on_pool(pool, step_fn, (params, optimizer.init(params)), args, device, log,
                      ("cls", "box", "kps"))
    finally:
        pool.stop()
    write_variables(model, args.out)
    log.info("trained BlazeFace variables written to %s", args.out)

    if not args.eval_scenes:
        return None
    # held-out scenes of the deploy-resolution distribution (the step
    # letterboxes identically)
    scenes = eval_scenes(idents, args.eval_scenes, args.seed, hw, args.max_faces, args.face_px)
    pr = held_out_pr(engine_config(args.input_px), args.out, scenes, device)
    log.info("held-out detection @%dx%d (production path): %s", hw[1], hw[0], pr)
    return pr


if __name__ == "__main__":
    main()
