"""The one traffic generator: a mix file's parameters -> a loop of
rendered 1080p frames with the faces' ground truth.

A mix (``benchmark/traffic/<name>.json``) states the frame size, the
loop's length, the identities, how many faces are visible at once
(``faces``), their patch side in pixels (``face_px``), the grid of
``slots`` each face moves inside (so faces never overlap), the speed,
how long a face stays (``dwell``, frames) and the per-frame chance that
one face leaves and another enters (``turnover``), and the chance per
frame that the number of visible faces steps by one (``count_walk``).

The schedule of arrivals, departures and sizes comes from a generator
fixed per mix (``schedule_seed``), so every seed serves the same set of
face counts, sizes and arrivals; the run's seed picks the background,
which identity each face shows, its slot, start and velocity, and where
in the loop the run starts.  Each identity's face is one patch rendered
once (the same pose in every frame), scaled to each face's size.
Frames are composed on ``device`` and handed back as host uint8 BGR
arrays, without per-frame noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from harness import faces


@dataclass
class Actor:
    start: int      # first frame
    end: int        # one past the last frame
    size: int       # patch side, px
    identity: int = 0
    slot: int = 0
    pos: Tuple[float, float] = (0.0, 0.0)
    vel: Tuple[float, float] = (0.0, 0.0)


@dataclass
class Loop:
    frames: List[np.ndarray]   # (H, W, 3) uint8 BGR, in playing order
    truth: List[np.ndarray]    # per frame (N, 6): actor, identity, x, y, w, h

    def faces_per_frame(self) -> np.ndarray:
        return np.asarray([len(t) for t in self.truth])


def schedule(mix: dict) -> List[Actor]:
    """The actors' start, end and size, from the mix's fixed schedule
    seed: the same for every run seed."""
    rng = np.random.default_rng(int(mix["schedule_seed"]))
    n_frames = int(mix["loop_frames"])
    lo, hi = mix["faces"]
    n_slots = int(np.prod(mix["slots"]))
    dwell, turnover, walk = mix.get("dwell"), float(mix.get("turnover", 0.0)), \
        float(mix.get("count_walk", 0.0))
    target = int(rng.integers(lo, hi + 1))
    live: List[Actor] = []
    done: List[Actor] = []

    def enter(f):
        life = int(rng.integers(dwell[0], dwell[1] + 1)) if dwell else n_frames + 1
        size = int(rng.integers(mix["face_px"][0], mix["face_px"][1] + 1))
        live.append(Actor(f, min(f + life, n_frames), size))

    for f in range(n_frames):
        for a in [a for a in live if a.end <= f]:
            live.remove(a)
            done.append(a)
        if turnover and live and rng.random() < turnover:
            a = live.pop(int(rng.integers(len(live))))
            a.end = f
            done.append(a)
        if walk and rng.random() < walk:
            target = int(np.clip(target + (1 if rng.random() < 0.5 else -1), lo, hi))
        while len(live) < min(target, n_slots):
            enter(f)
    for a in live:
        a.end = min(a.end, n_frames)
    return sorted(done + live, key=lambda a: a.start)


def _background(rng: np.random.Generator, hw, device) -> torch.Tensor:
    h, w = hw
    bg = torch.empty((h, w, 3), device=device)
    bg[:] = torch.as_tensor(rng.uniform(60, 200, 3), dtype=torch.float32, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    bg += (35 * ((xx - 0.5) + 0.3 * (yy - 0.5)))[..., None]
    for _ in range(6):
        bx, by = int(rng.integers(0, w)), int(rng.integers(0, h))
        bw, bh = int(rng.integers(w // 10, w // 3)), int(rng.integers(h // 10, h // 3))
        bg[by : by + bh, bx : bx + bw] = torch.as_tensor(rng.uniform(30, 225, 3),
                                                         dtype=torch.float32, device=device)
    return bg


def render(mix: dict, seed: int, device="cpu") -> Loop:
    """Render the mix's loop for ``seed`` on ``device``."""
    device = torch.device(device)
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 0x7A5F])
    h, w = mix["frame_hw"]
    n_frames = int(mix["loop_frames"])
    cols, rows = mix["slots"]
    cw, ch = w // cols, h // rows
    speed = float(mix["speed_px"])
    ident_rng = np.random.default_rng([int(seed) & (2**63 - 1), 0x1D])
    n_id = int(mix["identities"])
    idents = [faces.identity_params(ident_rng) for _ in range(n_id)]
    base = [faces.render_face_patch(idents[i], np.random.default_rng(ident_rng.integers(2**31)),
                                    160, max_rot=0.12) for i in range(n_id)]
    actors = schedule(mix)
    occupied = {}  # slot -> actor index, over time
    events = sorted([(a.start, 1, i) for i, a in enumerate(actors)]
                    + [(a.end, 0, i) for i, a in enumerate(actors)])
    for _f, kind, i in events:  # departures before arrivals at one frame
        a = actors[i]
        if kind == 0:
            occupied.pop(a.slot, None)
            continue
        free = [s for s in range(cols * rows) if s not in occupied]
        a.slot = int(free[int(rng.integers(len(free)))])
        occupied[a.slot] = i
        a.identity = int(rng.integers(n_id))
        sx, sy = (a.slot % cols) * cw, (a.slot // cols) * ch
        a.pos = (float(sx + rng.uniform(0, cw - a.size)), float(sy + rng.uniform(0, ch - a.size)))
        a.vel = tuple(float(v) for v in rng.uniform(-speed, speed, 2))
    bg = _background(rng, (h, w), device)

    patches = {}

    def patch(identity: int, size: int):
        key = (identity, size)
        if key not in patches:
            img, mask, bbox, _lm = base[identity]
            x = torch.as_tensor(np.concatenate([img[:, :, ::-1], mask[..., None]], -1).copy(),
                                dtype=torch.float32, device=device).permute(2, 0, 1)[None]
            y = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                              antialias=True)[0].permute(1, 2, 0)
            s = size / 160.0
            patches[key] = (y[..., :3], y[..., 3:].clamp(0, 1), bbox * s)
        return patches[key]

    frames, truth = [], []
    pos = {i: np.array(a.pos) for i, a in enumerate(actors)}
    vel = {i: np.array(a.vel) for i, a in enumerate(actors)}
    for f in range(n_frames):
        canvas = bg.clone()
        gt = []
        for i, a in enumerate(actors):
            if not a.start <= f < a.end:
                continue
            if f > a.start:
                p, v = pos[i], vel[i]
                p += v
                sx, sy = (a.slot % cols) * cw, (a.slot // cols) * ch
                for d, (lo, hi) in enumerate(((sx, sx + cw - a.size), (sy, sy + ch - a.size))):
                    if p[d] < lo or p[d] > hi:
                        v[d] = -v[d]
                        p[d] = np.clip(p[d], lo, hi)
            x0, y0 = int(pos[i][0]), int(pos[i][1])
            img, alpha, bbox = patch(a.identity, a.size)
            region = canvas[y0 : y0 + a.size, x0 : x0 + a.size]
            canvas[y0 : y0 + a.size, x0 : x0 + a.size] = region * (1 - alpha) + img * alpha
            gt.append((i, a.identity, x0 + bbox[0], y0 + bbox[1], bbox[2], bbox[3]))
        frames.append(canvas.clamp(0, 255).to(torch.uint8).cpu().numpy())
        truth.append(np.asarray(gt, np.float64).reshape(-1, 6))
    start = int(rng.integers(n_frames))
    return Loop(frames[start:] + frames[:start], truth[start:] + truth[:start])
