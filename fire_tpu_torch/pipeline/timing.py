"""Stage timing that understands asynchronous device work (counterpart
of ``fire_tpu.pipeline.timing``).

On a CUDA device a stage records a pair of CUDA events on the current
stream and is resolved later (:meth:`StageTimer.resolve`, after the
caller has synchronised), so timing adds no host sync to the pipeline.
On the CPU a stage is timed with the host clock.

A span (:meth:`StageTimer.span`) times host work that ends in its own
wait, such as a stage of the per-frame path that ends in a readback: its
host time goes into ``totals`` and its calls into ``counts``.  Spans
nest, a child taking its parent's name as a prefix (``match.readback``),
and while a ``torch.profiler`` records, each span is also a
``record_function`` range named ``fire.<name>``, on the profiler's
timeline beside the card's kernels and copies.  Components below the
recognizer open theirs through :func:`span`, inside the innermost span
open on the thread at the call (outside every span it does nothing), so
they need no timer of their own: ``sharded_cosine_topk``'s signature, for
one, stays as callers and replacements of it know it.  They add to the
innermost span's timer's ``counters`` the same way (:func:`count`: the
engine's ``encoding.rows`` and ``encoding.padded``).
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Tuple

import torch

log = logging.getLogger(__name__)

# the profiler's ranges of the program's spans are named PREFIX + span name
PREFIX = "fire."
_NO_SPAN = nullcontext()
# bound once: a span runs these on every frame's path
_clock = time.perf_counter
_profiling = torch._C._autograd._profiler_enabled
# record_function's own entry and exit, which also take the arguments as
# they are: an integer shows in the trace (with record_shapes)
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit
# a range with named arguments, shown in the trace: the one form that keeps
# a string argument (the range above records a string as empty)
_named_range = torch._C._profiler._RecordFunctionFast


class _Open(threading.local):
    """The spans open on this thread, innermost last."""

    def __init__(self):
        self.spans: List["_Span"] = []


_OPEN = _Open()


class _Span:
    """One timed interval of :meth:`StageTimer.span`."""

    __slots__ = ("timer", "name", "prefix", "args", "named", "stack", "t0", "range")

    def __init__(self, timer: "StageTimer", name: str, prefix: str, args: tuple, stack: list,
                 named: Optional[dict] = None):
        self.timer, self.name, self.prefix, self.args, self.stack = timer, name, prefix, args, stack
        self.named = named

    def __enter__(self):
        self.range = None
        if _profiling():
            if self.named:
                self.range = _named_range(PREFIX + self.name, self.args, self.named)
                self.range.__enter__()
            else:
                self.range = _range_enter(PREFIX + self.name, *self.args)
        self.stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        seconds = _clock() - self.t0
        self.stack.pop()
        totals, counts, name = self.timer.totals, self.timer.counts, self.name
        totals[name] = totals.get(name, 0.0) + seconds
        counts[name] = counts.get(name, 0) + 1
        if self.range is not None:
            if self.named:
                self.range.__exit__(None, None, None)
            else:
                _range_exit(self.range)
        return False


def span(name: str):
    """A span inside the innermost open span, of the timer that opened
    it; nothing outside every span."""
    spans = _OPEN.spans
    return spans[-1].timer.span(name) if spans else _NO_SPAN


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``<span>.<name>`` in the innermost open
    span's timer's ``counters`` (``encoding.rows``); nothing outside
    every span."""
    spans = _OPEN.spans
    if spans:
        counters, key = spans[-1].timer.counters, spans[-1].prefix + name
        counters[key] = counters.get(key, 0) + n


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}  # calls of each span in totals
        self.counters: Dict[str, int] = {}  # what count() added, by name
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

    def span(self, name: str, frame: Optional[int] = None, **named) -> _Span:
        """Time the enclosed host work: its seconds go into
        ``totals[name]`` and one call into ``counts[name]``, where
        ``name`` is ``<parent>.<name>`` inside another span of this
        timer.  ``frame``
        makes it a frame's span: the profiler's range takes the frame
        index as its argument, and its children keep their own names.
        Keyword arguments (strings or numbers: ``encoder=``,
        ``bucket=``) become the profiler range's named arguments."""
        spans = _OPEN.spans
        if spans and spans[-1].timer is self:
            name = spans[-1].prefix + name
        if frame is None:
            return _Span(self, name, name + ".", (), spans, named)
        return _Span(self, name, "", (frame,), spans, named)

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
