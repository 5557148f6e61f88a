"""Host frame sources with decode-ahead prefetching (counterpart of
``fire_tpu.pipeline.stream``).  No OpenCV is needed for in-RAM frames."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

_SENTINEL = object()

# cv2.CAP_PROP_* values, so callers may pass either the cv2 constant or
# the number
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4
CAP_PROP_FPS = 5


class FrameSequenceCapture:
    """cv2.VideoCapture-compatible shim over in-RAM BGR frames
    (``read``, ``get``, ``isOpened``, ``release``)."""

    def __init__(self, frames, fps: float = 30.0):
        self._frames = iter(frames)
        try:
            self._first = next(self._frames)
        except StopIteration:
            self._first = None
        self._hw = self._first.shape[:2] if self._first is not None else (0, 0)
        self.fps = fps

    def isOpened(self) -> bool:  # noqa: N802 - cv2 API parity
        return self._hw != (0, 0)

    def read(self):
        if self._first is not None:
            f, self._first = self._first, None
            return True, f
        try:
            return True, next(self._frames)
        except StopIteration:
            return False, None

    def get(self, prop) -> float:
        if prop == CAP_PROP_FPS:
            return float(self.fps)
        if prop == CAP_PROP_FRAME_WIDTH:
            return float(self._hw[1])
        if prop == CAP_PROP_FRAME_HEIGHT:
            return float(self._hw[0])
        return 0.0

    def release(self) -> None:
        self._frames = iter(())


class PrefetchReader:
    """Background-thread frame reader over a VideoCapture-like source."""

    def __init__(self, cap, depth: int = 8):
        self.cap = cap
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            ret, frame = self.cap.read()
            if not ret:
                break
            while not self._stop.is_set():
                try:
                    self.q.put(frame, timeout=0.5)
                    break
                except queue.Full:
                    continue
        while True:
            try:
                self.q.put(_SENTINEL, timeout=0.5)
                return
            except queue.Full:
                if self._stop.is_set():
                    return

    def frames(self) -> Iterator[np.ndarray]:
        while True:
            item = self.q.get()
            if item is _SENTINEL:
                return
            yield item

    def read(self) -> Optional[np.ndarray]:
        """The next frame, or None at the end of the stream."""
        item = self.q.get()
        return None if item is _SENTINEL else item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
