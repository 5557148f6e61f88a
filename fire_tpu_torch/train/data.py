"""Training data: identity-folder datasets → uint8 batches (counterpart
of ``fire_tpu.train.data``).

The layout is ``root/<identity>/<image>`` (CASIA-style).  Images are
decoded on a background thread without OpenCV
(:func:`fire_tpu_torch.utils.imageio.imread`: PNG, BMP, PPM; JPEG where
OpenCV is installed) and resized with the INTER_AREA resampler of
:mod:`fire_tpu_torch.train.scenes`; normalisation happens in the step.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np

from fire_tpu_torch.train.scenes import resize_area_u8
from fire_tpu_torch.utils import imageio


class IdentityFolderDataset:
    """Indexes ``root/<identity>/<image>`` into (path, class_id) pairs."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str):
        self.root = root
        self.classes: List[str] = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.samples: List[Tuple[str, int]] = []
        for cid, name in enumerate(self.classes):
            d = os.path.join(root, name)
            for f in sorted(os.listdir(d)):
                if f.lower().endswith(self.EXTS):
                    self.samples.append((os.path.join(d, f), cid))
        if not self.samples:
            raise ValueError(f"no images found under {root}")

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self) -> int:
        return len(self.samples)


def _load(path: str, image_hw) -> np.ndarray:
    img = imageio.imread(path)
    if img is None:
        raise ValueError(f"cannot decode {path}")
    if img.shape[:2] != tuple(image_hw):
        img = resize_area_u8(img, tuple(image_hw))
    return img[..., ::-1]  # BGR → RGB (FaceNet input contract)


def batches(ds: IdentityFolderDataset, batch_size: int, image_hw=(160, 160), seed: int = 0,
            epochs: int = 1, prefetch: int = 4) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled ``(images uint8 RGB (B,H,W,3), labels int32 (B,))``
    batches, decoded on a background thread; each epoch drops its last
    partial batch.  A decode error is raised here; the thread stops when
    the generator is closed."""
    rng = np.random.default_rng(seed)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    done = threading.Event()
    end = object()

    def put(item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for _ in range(epochs):
                order = rng.permutation(len(ds.samples))
                for i in range(0, len(order) - batch_size + 1, batch_size):
                    idx = order[i : i + batch_size]
                    imgs = np.stack([_load(ds.samples[j][0], image_hw) for j in idx])
                    labels = np.asarray([ds.samples[j][1] for j in idx], np.int32)
                    if not put((imgs, labels)):
                        return
            put(end)
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        done.set()
        thread.join(timeout=5)
