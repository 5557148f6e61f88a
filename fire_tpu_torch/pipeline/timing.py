"""Stage timing that understands asynchronous device work (counterpart
of ``fire_tpu.pipeline.timing``).

On a CUDA device a stage records a pair of CUDA events on the current
stream and is resolved later (:meth:`StageTimer.resolve`, after the
caller has synchronised), so timing adds no host sync to the pipeline.
On the CPU a stage is timed with the host clock.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

log = logging.getLogger(__name__)


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.frame_count = 0
        self.start_time: Optional[float] = None
        self._events: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def start(self) -> None:
        if self.start_time is None:
            self.start_time = time.time()

    @contextmanager
    def stage(self, name: str, device: Optional[torch.device] = None):
        """Time the enclosed work: device time between CUDA events when
        ``device`` is a CUDA device, host time otherwise."""
        if device is not None and torch.device(device).type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                yield
            finally:
                e1.record()
                self._events.append((name, e0, e1))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(name, time.perf_counter() - t0)

    def resolve(self, wait: bool = True) -> None:
        """Fold recorded CUDA event pairs into the totals, in the order
        they were recorded: all of them, waiting for each pair's last
        event, or (``wait=False``) those the card has finished, so that
        collecting one batch does not wait for the batches queued after
        it."""
        done = 0
        for name, e0, e1 in self._events:
            if wait:
                e1.synchronize()
            elif not e1.query():
                break
            self.add(name, e0.elapsed_time(e1) / 1000.0)
            done += 1
        del self._events[:done]

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    def tick_frame(self) -> None:
        self.frame_count += 1

    def print_image_report(self) -> None:
        """Image-mode stage table."""
        print("\n--- Image Processing Timings ---")
        for step, duration in self.totals.items():
            print(f"{step}: {duration:.4f} seconds")
        print(f"Total Processing Time: {sum(self.totals.values()):.4f} seconds\n")

    def log_stream_report(self) -> None:
        """End-of-run FPS + per-stage ms/frame."""
        self.resolve()
        if self.frame_count == 0 or self.start_time is None:
            return
        elapsed = time.time() - self.start_time
        log.info("Total frames processed: %d", self.frame_count)
        log.info("Total processing time: %.2f seconds", elapsed)
        log.info("Average FPS: %.2f", self.frame_count / elapsed if elapsed > 0 else 0.0)
        for name, total in self.totals.items():
            log.info("Average %s Time: %.2f ms/frame", name.capitalize(),
                     total / self.frame_count * 1000.0)
