"""YuNet detector training on synthetic scenes, and detector scoring
(counterpart of ``fire_tpu.train.detect``).

* Anchor-free centre assignment, the inverse of
  :func:`fire_tpu_torch.ops.anchors.yunet_grid_decode`: a face goes to
  one stride by size (< 45 px: 8, < 90 px: 16, else 32); every cell
  whose centre lies in its central half-box, and the cell holding its
  centre, is positive with the regression targets the decode inverts.
  Other cells inside the box are ignored (weight 0).
* Focal BCE on cls and obj, computed from the heads' sigmoid
  probabilities clipped to [1e-6, 1 − 1e-6] as JAX computes it (not
  BCE-with-logits, a different function at the clip); smooth-L1 on box
  and landmarks at positive cells.
* :func:`build_targets` builds one scene's targets on the host (numpy,
  copied from JAX); :func:`build_targets_device` builds a batch's on the
  device from padded GT, gathering each cell's face by index, and equals
  the host builder, including its "the last face that touches a cell
  decides" overwrite order.
* The trainers sample batches from scenes resident on the device
  (:func:`train_on_pool`): the step gathers, casts and builds targets on
  the device, so a step's host-to-device copy is the (B,) index vector;
  on a card each step replays a CUDA graph captured at its key's first
  call, as JAX jits it (:func:`detector_step`);
  :class:`ScenePool` threads synthesise a fresh scene for each one
  sampled, and a block of the device pool is overwritten every few steps
  (:func:`update_pool_rows`).

``python -m fire_tpu_torch.train.detect`` trains the deployable YuNet
and writes a Flax msgpack that ``DeviceEngine.load_trained_detector`` of
either package loads.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from fire_tpu_torch.runtime.graphs import GraphedStep, HostStaging

STRIDES = (8, 16, 32)
# geometric size bands: stride s owns faces around 4·s px
# (8: <45px, 16: 45-90px, 32: >90px)
_LEVEL_EDGES = (45.0, 90.0)


def assign_level(size_px: float) -> int:
    if size_px < _LEVEL_EDGES[0]:
        return 0
    if size_px < _LEVEL_EDGES[1]:
        return 1
    return 2


def build_targets(boxes_xywh: np.ndarray, lms: np.ndarray, hw: Tuple[int, int],
                  strides: Sequence[int] = STRIDES) -> Dict[int, Tuple[np.ndarray, ...]]:
    """Per-stride training targets for one scene: ``{stride: (cls_t
    (H', W'), box_t (H', W', 4), kps_t (H', W', 10), weight (H', W'))}``
    with ``H' = H / stride``; weight 0 marks ignored in-box cells."""
    h, w = hw
    grids = {}
    for st in strides:
        gh, gw = h // st, w // st
        grids[st] = (
            np.zeros((gh, gw), np.float32),        # cls/obj target
            np.zeros((gh, gw, 4), np.float32),     # box target
            np.zeros((gh, gw, 10), np.float32),    # kps target
            np.ones((gh, gw), np.float32),         # loss weight
        )
    for i in range(boxes_xywh.shape[0]):
        x, y, bw, bh = boxes_xywh[i]
        cx, cy = x + bw / 2.0, y + bh / 2.0
        size = float(np.sqrt(max(bw, 1e-3) * max(bh, 1e-3)))
        st = strides[assign_level(size)]
        cls_t, box_t, kps_t, wgt = grids[st]
        gh, gw = cls_t.shape
        # ignore every cell whose index range falls inside the GT box;
        # the positive region is re-marked below
        c0 = int(np.clip(x // st, 0, gw - 1))
        c1 = int(np.clip((x + bw) // st, 0, gw - 1))
        r0 = int(np.clip(y // st, 0, gh - 1))
        r1 = int(np.clip((y + bh) // st, 0, gh - 1))
        wgt[r0 : r1 + 1, c0 : c1 + 1] = 0.0
        # centre sampling: cells whose centre lies in the central half-box
        col_c = int(np.clip(cx // st, 0, gw - 1))
        row_c = int(np.clip(cy // st, 0, gh - 1))
        cols = np.arange(gw, dtype=np.float32)
        rows = np.arange(gh, dtype=np.float32)
        in_cx = np.abs((cols + 0.5) * st - cx) <= bw / 4.0
        in_cy = np.abs((rows + 0.5) * st - cy) <= bh / 4.0
        pos = np.outer(in_cy, in_cx)
        pos[row_c, col_c] = True  # centre cell always positive
        prs, pcs = np.nonzero(pos)
        cls_t[prs, pcs] = 1.0
        wgt[prs, pcs] = 1.0
        box_t[prs, pcs] = np.stack(
            [
                cx / st - pcs,
                cy / st - prs,
                np.full_like(pcs, np.log(max(bw, 1e-3) / st), np.float64),
                np.full_like(pcs, np.log(max(bh, 1e-3) / st), np.float64),
            ],
            axis=-1,
        )
        k = lms[i].astype(np.float32)
        kps_t[prs, pcs] = np.stack(
            [k[None, :, 0] / st - pcs[:, None], k[None, :, 1] / st - prs[:, None]],
            axis=-1,
        ).reshape(len(prs), 10)
    return {st: grids[st] for st in strides}


def stack_targets(per_scene: List[dict], strides: Sequence[int] = STRIDES):
    """List of per-scene target dicts → per-stride batched arrays."""
    return {st: tuple(np.stack([t[st][j] for t in per_scene]) for j in range(4))
            for st in strides}


def pad_gt(boxes: np.ndarray, lms: np.ndarray, max_faces: int):
    """Variable-N GT → fixed (max_faces, ...) padded arrays + valid mask
    (for the device-side target builders)."""
    f = max_faces
    b = np.zeros((f, 4), np.float32)
    l = np.zeros((f, 5, 2), np.float32)
    v = np.zeros((f,), bool)
    n = min(boxes.shape[0], f)
    b[:n], l[:n], v[:n] = boxes[:n], lms[:n], True
    return b, l, v


def gather_faces(v: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``v`` (B, F, *rest) gathered by a face index per cell ``sel``
    (B, *cells) → (B, *cells, *rest), exact."""
    b, cells, rest = sel.shape[0], sel.shape[1:], v.shape[2:]
    flat = sel.reshape(b, -1)
    return v[torch.arange(b, device=v.device)[:, None], flat].reshape(b, *cells, *rest)


def build_targets_device(boxes: torch.Tensor, lms: torch.Tensor, valid: torch.Tensor,
                         hw: Tuple[int, int], strides: Sequence[int] = STRIDES):
    """Batched targets on the device, equal to :func:`build_targets`.

    ``boxes`` (B, F, 4) xywh, ``lms`` (B, F, 5, 2), ``valid`` (B, F)
    bool.  Returns the per-stride dict of :func:`build_targets`, batched.
    Where faces overlap, the host builder's sequential writes decide:
    the last face touching a cell (its positives or its ignore region)
    sets the cell's weight, and the last face whose positives hold the
    cell sets its regression targets."""
    h, w = hw
    dev = boxes.device
    x, y, bw, bh = boxes.unbind(-1)
    cx, cy = x + bw / 2.0, y + bh / 2.0
    size = torch.sqrt(torch.clamp(bw, min=1e-3) * torch.clamp(bh, min=1e-3))
    lvl = torch.where(size < _LEVEL_EDGES[0], 0, torch.where(size < _LEVEL_EDGES[1], 1, 2))
    rank = torch.arange(1, boxes.shape[1] + 1, device=dev)[None, :, None, None]
    out = {}
    for li, st in enumerate(strides):
        gh, gw = h // st, w // st
        ok = valid & (lvl == li)  # (B, F)
        cols = torch.arange(gw, dtype=torch.float32, device=dev)
        rows = torch.arange(gh, dtype=torch.float32, device=dev)
        # centre-sampling positives (+ the centre cell itself)
        in_cx = torch.abs((cols + 0.5) * st - cx[..., None]) <= bw[..., None] / 4.0
        in_cy = torch.abs((rows + 0.5) * st - cy[..., None]) <= bh[..., None] / 4.0
        colc = torch.clamp(torch.floor(cx / st), 0, gw - 1)
        rowc = torch.clamp(torch.floor(cy / st), 0, gh - 1)
        cen_x = cols == colc[..., None]
        cen_y = rows == rowc[..., None]
        pos_f = ((in_cy[..., :, None] & in_cx[..., None, :])
                 | (cen_y[..., :, None] & cen_x[..., None, :]))
        pos_f = pos_f & ok[..., None, None]  # (B, F, gh, gw)
        # in-box ignore region: cell-index ranges, as the host writes them
        j0 = torch.clamp(torch.floor(x / st), 0, gw - 1)[..., None]
        j1 = torch.clamp(torch.floor((x + bw) / st), 0, gw - 1)[..., None]
        i0 = torch.clamp(torch.floor(y / st), 0, gh - 1)[..., None]
        i1 = torch.clamp(torch.floor((y + bh) / st), 0, gh - 1)[..., None]
        inb = (((rows >= i0) & (rows <= i1))[..., :, None]
               & ((cols >= j0) & (cols <= j1))[..., None, :])
        inb = inb & ok[..., None, None]
        # 1 + the index of the last face touching / holding each cell; 0: none
        last_touch = torch.where(pos_f | inb, rank, 0).amax(dim=1)  # (B, gh, gw)
        last_pos = torch.where(pos_f, rank, 0).amax(dim=1)
        sel_t = torch.clamp(last_touch - 1, min=0)
        outcome = pos_f.gather(1, sel_t[:, None]).squeeze(1)
        wgt = torch.where(last_touch > 0, outcome.float(), 1.0)
        cls_t = (last_pos > 0).float()
        sel_p = torch.clamp(last_pos - 1, min=0)

        def g(v):  # (B, F, ...) → (B, gh, gw, ...) by the selected face
            return gather_faces(v, sel_p)

        tx = g(cx) / st - cols
        ty = g(cy) / st - rows[:, None]
        tw = g(torch.log(torch.clamp(bw, min=1e-3) / st))
        th = g(torch.log(torch.clamp(bh, min=1e-3) / st))
        box_t = torch.stack([tx, ty, tw, th], dim=-1) * cls_t[..., None]
        k = g(lms)  # (B, gh, gw, 5, 2)
        tkx = k[..., 0] / st - cols[:, None]
        tky = k[..., 1] / st - rows[:, None, None]
        kps_t = torch.stack([tkx, tky], dim=-1).reshape(*cls_t.shape, 10) * cls_t[..., None]
        out[st] = (cls_t, box_t, kps_t, wgt)
    return out


# --------------------------------------------------------------- loss ---


def smooth_l1(d: torch.Tensor) -> torch.Tensor:
    a = torch.abs(d)
    return torch.where(a < 1.0, 0.5 * a * a, a - 0.5)


def focal_bce(p: torch.Tensor, t: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """Per-element focal BCE of probabilities ``p`` (clipped to
    [1e-6, 1 − 1e-6]) against targets ``t``."""
    p = torch.clamp(p, 1e-6, 1.0 - 1e-6)
    pos = -alpha * t * (1.0 - p) ** gamma * torch.log(p)
    neg = -(1.0 - alpha) * (1.0 - t) * p ** gamma * torch.log(1.0 - p)
    return pos + neg


def detection_loss(heads, targets, box_weight: float = 2.0, kps_weight: float = 0.25,
                   alpha: float = 0.75, gamma: float = 2.0):
    """Multi-task loss over the YuNet heads ``{stride: (cls, obj, box,
    kps)}`` (sigmoid cls / obj, the deployment contract) against
    ``{stride: (cls_t, box_t, kps_t, weight)}``.  Returns ``(loss,
    metrics)``."""
    total_pos = 1e-6
    cls_l = obj_l = box_l = kps_l = 0.0
    for st, (cls, obj, box, kps) in heads.items():
        cls_t, box_t, kps_t, wgt = targets[st]
        total_pos = total_pos + cls_t.sum()
        cls_l = cls_l + (focal_bce(cls[..., 0], cls_t, alpha, gamma) * wgt).sum()
        obj_l = obj_l + (focal_bce(obj[..., 0], cls_t, alpha, gamma) * wgt).sum()
        box_l = box_l + (smooth_l1(box - box_t).sum(-1) * cls_t).sum()
        kps_l = kps_l + (smooth_l1(kps - kps_t).sum(-1) * cls_t).sum()
    loss = (cls_l + obj_l + box_weight * box_l + kps_weight * kps_l) / total_pos
    return loss, {"cls": cls_l / total_pos, "obj": obj_l / total_pos,
                  "box": box_l / total_pos, "kps": kps_l / total_pos, "n_pos": total_pos}


# ------------------------------------------------------------- steps ---

METRICS = ("cls", "obj", "box", "kps", "n_pos")


def detector_step(body, names: Sequence[str], bound: int = 0):
    """``body(state, *args) → (loss, metrics)``, which updates ``state``
    in place, as a :class:`~fire_tpu_torch.runtime.graphs.GraphedStep`
    (a CUDA graph per key on a card) whose result is ``(state, loss,
    metrics)``.  The loss and the metrics ``names`` leave the step as one
    vector, one output of the graph."""

    def packed(state, *args):
        loss, metrics = body(state, *args)
        return (torch.stack([loss, *(metrics[k] for k in names)]).detach(),)

    def finish(state, out):
        return state, out[0][0], dict(zip(names, out[0][1:]))

    return GraphedStep(packed, finish, bound)


def _step(model, optimizer, state, images, targets, box_weight, kps_weight, compute_dtype):
    from fire_tpu_torch.train.trainer import compute_context, optimizer_step

    params, _, opt_state = state
    with compute_context(images.device, compute_dtype):
        heads = model(images, train=True)
    loss, metrics = detection_loss(heads, targets, box_weight=box_weight, kps_weight=kps_weight)
    optimizer_step(optimizer, params, opt_state, loss)
    return loss, metrics


def make_detect_train_step(model, optimizer, strides=STRIDES, box_weight: float = 2.0,
                           kps_weight: float = 0.25, compute_dtype=None):
    """``step((params, batch_stats, opt_state), images01, targets) →
    (state, loss, metrics)``; ``params`` / ``batch_stats`` are the
    model's own tensors (``list(model.parameters())``,
    :func:`~fire_tpu_torch.train.trainer.model_batch_stats`), updated in
    place.  On a card a graph per key (the shapes of the images and
    targets, the state's tensors), as JAX jits the step."""

    def body(state, images, targets):
        return _step(model, optimizer, state, images, targets, box_weight, kps_weight,
                     compute_dtype)

    return detector_step(body, METRICS)


def make_pool_train_step(model, optimizer, hw: Tuple[int, int], strides=STRIDES,
                         box_weight: float = 2.0, kps_weight: float = 0.25,
                         compute_dtype=None):
    """``step(state, pool_imgs u8 (N,H,W,3), pool_boxes (N,F,4),
    pool_lms, pool_valid, idx (B,)) → (state, loss, metrics)`` on scenes
    resident on the device: the batch gather, the uint8 → float cast and
    the targets (:func:`build_targets_device`) run there.  On a card the
    four pool tensors are bound to the graph of their key (read as they
    are, rewritten in place between steps by :func:`update_pool_rows`;
    other pool tensors get a key of their own) and only ``idx`` is
    copied in."""

    def body(state, pool_imgs, pool_boxes, pool_lms, pool_valid, idx):
        images = pool_imgs[idx].float() / 255.0
        targets = build_targets_device(pool_boxes[idx], pool_lms[idx], pool_valid[idx], hw,
                                       strides)
        return _step(model, optimizer, state, images, targets, box_weight, kps_weight,
                     compute_dtype)

    return detector_step(body, METRICS, bound=4)


def update_pool_rows(arr: torch.Tensor, block: np.ndarray, start: int,
                     staging=None) -> torch.Tensor:
    """Overwrite rows ``start : start + len(block)`` of the device pool
    array ``arr`` in place (the rolling refresh); returns ``arr``.  The
    block goes up through ``staging``'s pinned buffers (a loop's own
    :class:`~fire_tpu_torch.runtime.graphs.HostStaging`, reused across
    refreshes), without waiting for the card."""
    rows = arr[start : start + block.shape[0]]
    (staging or HostStaging()).upload(block, arr.device, out=rows)
    return arr


def warm_start_variables(variables: Dict, path: str) -> Dict:
    """A previous run's msgpack (the fine-tune init) in place of
    ``variables``: the same tree with the same leaf shapes, or a
    ``ValueError`` naming the first leaf that differs.  Committed files
    hold bf16; every float leaf comes back as a float32 numpy master."""
    from fire_tpu_torch.weights import flatten, read_msgpack, unflatten

    template = {"/".join(p): tuple(np.shape(leaf)) for p, leaf in flatten(variables).items()}
    loaded = flatten(read_msgpack(path))
    got = {"/".join(p) for p in loaded}
    if got != set(template):
        raise ValueError(
            f"checkpoint/model tree mismatch: checkpoint {path} lacks "
            f"{sorted(set(template) - got)[:3]} and adds {sorted(got - set(template))[:3]} — "
            f"wrong --init_from file or model configuration?")
    for p, leaf in loaded.items():
        key = "/".join(p)
        if template[key] != tuple(np.shape(leaf)):
            raise ValueError(
                f"checkpoint/model shape mismatch at {key!r}: checkpoint {path} has "
                f"{tuple(np.shape(leaf))}, the configured model expects {template[key]} — "
                f"wrong --init_from file or model configuration?")
    return unflatten({p: np.asarray(a, np.float32)
                      if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a)
                      for p, a in loaded.items()})


# --------------------------------------------------------- scene pool ---


class ScenePool:
    """Fixed-size example pool refreshed by daemon generator threads.

    The trainer samples with replacement; the threads grow the pool to
    ``size`` scenes, then overwrite a random slot with a fresh scene for
    each scene sampled.  (JAX's threads overwrite without pause.  Here a
    generator thread that never waits would take the interpreter lock
    from the training loop, whose step is thousands of eager launches
    where JAX's is one jitted call.)  ``stop()`` joins the threads."""

    def __init__(self, gen_fn, size: int = 512, threads: int = 4, seed: int = 0):
        self._gen = gen_fn
        self._cond = threading.Condition()
        self._stop = threading.Event()
        rng0 = np.random.default_rng(seed)
        # fill synchronously so training can start on a small warm pool
        warm = min(size, 64)
        self._pool = [gen_fn(np.random.default_rng(rng0.integers(2**63))) for _ in range(warm)]
        self._size = size
        self._made = warm
        self._owed = 0  # fresh scenes due for the ones sampled, at most `size`
        self._threads = [
            threading.Thread(target=self._worker, args=(seed + 1000 + i,), daemon=True)
            for i in range(threads)
        ]
        for t in self._threads:
            t.start()

    def _worker(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            with self._cond:
                if len(self._pool) >= self._size:
                    if self._owed == 0:
                        self._cond.wait(timeout=0.1)
                        continue
                    self._owed -= 1
            ex = self._gen(np.random.default_rng(rng.integers(2**63)))
            with self._cond:
                if len(self._pool) < self._size:
                    self._pool.append(ex)
                else:
                    self._pool[int(rng.integers(0, self._size))] = ex
                self._made += 1

    def sample(self, n: int, rng: np.random.Generator):
        with self._cond:
            idx = rng.integers(0, len(self._pool), n)
            self._owed = min(self._owed + n, self._size)
            self._cond.notify_all()
            return [self._pool[i] for i in idx]

    @property
    def generated(self) -> int:
        with self._cond:
            return self._made

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)


def train_on_pool(pool: ScenePool, step_fn, state, args, device: torch.device, log,
                  metric_names: Sequence[str], on_step=None):
    """The detector trainers' loop (JAX's, shared): stage
    ``args.device_pool`` scenes of ``pool`` on the device, take
    ``args.steps`` steps of ``args.batch`` scenes drawn with replacement,
    overwrite the next ``args.refresh_block`` rows every
    ``args.refresh_every`` steps, log every ``args.log_every``;
    ``on_step(state, step)`` runs after each step.  Returns the state.

    As JAX's loop: the index vector and the refreshed rows go up through
    pinned buffers (the step's own and the loop's
    :class:`~fire_tpu_torch.runtime.graphs.HostStaging`), and the only
    read of the device is the loss and metrics of a logging step."""
    rng = np.random.default_rng(args.seed + 7)
    staging = HostStaging()

    def block(n):
        ex = pool.sample(n, rng)
        return tuple(np.stack([e[j] for e in ex]) for j in range(4))

    n_pool = args.device_pool
    host = block(n_pool)
    pool_dev = [torch.from_numpy(a).to(device) for a in host]
    log.info("device pool staged: %d scenes (%.1f MB)", n_pool, host[0].nbytes / 1e6)
    fmt = ("step %d  loss %.4f  " + " ".join(f"{k} %.4f" for k in metric_names)
           + "  (%.1f img/s, %d scenes synthesized)")
    refresh_at = 0
    t0 = time.time()
    for step in range(1, args.steps + 1):
        idx = rng.integers(0, n_pool, args.batch)
        state, loss, metrics = step_fn(state, *pool_dev, idx)
        if args.refresh_every and step % args.refresh_every == 0:
            fresh = block(min(args.refresh_block, n_pool))
            start = refresh_at
            refresh_at = (refresh_at + fresh[0].shape[0]) % max(n_pool - fresh[0].shape[0] + 1, 1)
            pool_dev = [update_pool_rows(d, b, start, staging) for d, b in zip(pool_dev, fresh)]
        if step % args.log_every == 0:
            values = torch.stack([loss, *(metrics[k] for k in metric_names)]).tolist()
            log.info(fmt, step, *values, step * args.batch / (time.time() - t0), pool.generated)
        if on_step is not None:
            on_step(state, step)
    return state


# ----------------------------------------------------------- evaluation ---


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


def held_out_pr(cfg, path: str, scenes, device) -> Dict[str, float]:
    """Detection P/R of the weights at ``path`` through the production
    path (``DeviceEngine(cfg).detect_faces``) on GT ``scenes``."""
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    eng = DeviceEngine(cfg, device=device)
    eng.load_trained_detector(path)
    return detection_pr(eng.detect_faces, scenes)


def eval_scenes(idents, n: int, seed: int, hw, max_faces: int, face_px) -> list:
    """The trainers' held-out scenes: ``n`` scenes of ``hw`` from the
    evaluation seed ``seed + 31337``."""
    from fire_tpu_torch.train.scenes import compose_scene

    rng = np.random.default_rng(seed + 31337)
    return [compose_scene(rng, idents, hw=tuple(hw), n_faces=(1, max_faces),
                          face_px=tuple(face_px)) for _ in range(n)]


def write_variables(model: torch.nn.Module, path: str) -> None:
    """The model's Flax variables as msgpack, written atomically."""
    import os

    from fire_tpu_torch.weights import msgpack_serialize, to_flax

    with open(path + ".tmp", "wb") as f:
        f.write(msgpack_serialize(to_flax(model)))
    os.replace(path + ".tmp", path)


# ----------------------------------------------------------------- CLI ---


def main(argv=None):
    """``python -m fire_tpu_torch.train.detect``: train the deployable
    YuNet on synthetic scenes and write engine-loadable detector
    variables.  Returns the held-out P/R (None without
    ``--eval_scenes``)."""
    import argparse
    import logging

    ap = argparse.ArgumentParser(description="FIRE YuNet detector training (PyTorch)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=320, help="square train resolution")
    ap.add_argument("--width", type=int, default=64, help="YuNet trunk width")
    ap.add_argument("--identities", type=int, default=200)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--pool", type=int, default=768)
    ap.add_argument("--gen_threads", type=int, default=6)
    ap.add_argument("--max_faces", type=int, default=3)
    ap.add_argument("--face_px", type=int, nargs=2, default=(24, 192))
    ap.add_argument("--out", default="trained_yunet.msgpack")
    ap.add_argument("--eval_scenes", type=int, default=64)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device_pool", type=int, default=512,
                    help="scenes resident on the device; batches sample there")
    ap.add_argument("--refresh_block", type=int, default=32,
                    help="fresh scenes shipped to the device pool per refresh")
    ap.add_argument("--refresh_every", type=int, default=10,
                    help="steps between device-pool block refreshes")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("fire_tpu_torch.train.detect")

    from fire_tpu_torch.device import resolve_device
    from fire_tpu_torch.models.yunet import YuNet
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.scenes import compose_scene, make_identities
    from fire_tpu_torch.train.trainer import cli_compute_dtype, model_batch_stats
    from fire_tpu_torch.weights import flax_shapes, load_flax, materialize

    device = resolve_device(args.device)
    idents = make_identities(args.identities, seed=args.seed)
    hw = (args.size, args.size)

    def gen(rng):
        img, boxes, lms = compose_scene(rng, idents, hw=hw, n_faces=(1, args.max_faces),
                                        face_px=tuple(args.face_px))
        return (img, *pad_gt(boxes, lms, args.max_faces))

    model = YuNet(width=args.width).to(device)
    # the JAX trainer's numpy init (fan-in LeCun normal per parameter path)
    load_flax(model, materialize(flax_shapes(model), seed=args.seed))
    optimizer = optim.chain(
        optim.clip_by_global_norm(5.0),
        optim.adamw(optim.cosine_decay_schedule(args.lr, args.steps, 0.05)),
    )
    params = list(model.parameters())
    state = (params, model_batch_stats(model), optimizer.init(params))
    step_fn = make_pool_train_step(model, optimizer, hw, compute_dtype=cli_compute_dtype(device))

    pool = ScenePool(gen, size=args.pool, threads=args.gen_threads, seed=args.seed)
    try:
        train_on_pool(pool, step_fn, state, args, device, log, ("cls", "obj", "box", "kps"))
    finally:
        pool.stop()
    write_variables(model, args.out)
    log.info("trained detector variables written to %s", args.out)

    if not args.eval_scenes:
        return None
    from fire_tpu_torch.config import RecognizerConfig

    cfg = RecognizerConfig(weights_dir=None).with_embedding_dim()
    scenes = eval_scenes(idents, args.eval_scenes, args.seed, (480, 640), args.max_faces,
                         args.face_px)
    pr = held_out_pr(cfg, args.out, scenes, device)
    log.info("held-out detection @640x480: %s", pr)
    return pr


if __name__ == "__main__":
    main()
