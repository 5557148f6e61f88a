"""What a traced window says: the card's busy time (the union of its
kernel and copy intervals, per card), kernel time by name, and the idle
gaps named by the host span that was open when each gap began.

The busy and idle arithmetic is a copy of the one the port's chip
smoke test used; the spans are the benchmark's own
(:class:`harness.drive.Recorder` opens them around the program's
calls)."""

from __future__ import annotations

from typing import Dict, List, Tuple


# the benchmark's host spans (:class:`harness.drive.Recorder`)
SPANS = ("frame", "detect", "encode", "match", "enrol", "tracker", "submit",
         "collect (wait + readback)", "stream_results")


# a gap while none of those spans was open: in the batched loop the
# stacking of the batch and the frame reader, in the per-frame loop the
# benchmark's own loop
OUTSIDE = "outside the program's calls"


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total covered length and the merged intervals of ``spans``."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


def summarize(prof, window_s: float) -> Dict:
    """From a finished profiler run of ``window_s`` seconds of host time:
    ``busy_s`` (averaged over the cards that ran anything), per-card
    busy seconds, device seconds by kernel name, the ten device
    operations and the ten idle-gap causes that took most time (each gap
    of the first card named by the innermost benchmark span open when it
    began)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    # kernels, copies and sets on the card; not the host spans the
    # profiler mirrors onto its timeline
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.name not in SPANS]
    by_card: Dict[int, List[Tuple[float, float]]] = {}
    by_name: Dict[str, float] = {}
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        by_card.setdefault(int(e.device_index), []).append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
    busy = {c: _union(s)[0] / 1e6 for c, s in by_card.items()}
    # host spans opened by the benchmark (record_function) and the
    # program's own top-level ops, for naming the gaps on the first card
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name in SPANS]
    gaps: Dict[str, float] = {}
    first = min(by_card) if by_card else None
    if first is not None:
        _, merged = _union(by_card[first])
        for (_, end), (start, _) in zip(merged, merged[1:]):
            if start <= end:
                continue
            mid = end + 1e-3
            open_spans = [(b - a, n) for a, b, n in host if a <= mid <= b]
            name = min(open_spans)[1] if open_spans else OUTSIDE
            gaps[name] = gaps.get(name, 0.0) + (start - end) / 1e6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": window_s,
        "busy_s": (sum(busy.values()) / len(busy)) if busy else 0.0,
        "busy_first_s": busy.get(first, 0.0) if first is not None else 0.0,
        "busy_by_card_s": {str(c): v for c, v in sorted(busy.items())},
        "kernel_s": by_name,
        "device_ops": [[n[:120], v] for n, v in top_ops],
        "idle_gaps": [[n[:120], v] for n, v in top_gaps],
    }


def kernel_seconds(summary: Dict, names) -> float:
    """Device seconds of the kernels whose name contains one of ``names``."""
    return sum(v for k, v in summary["kernel_s"].items() if any(n in k for n in names))
