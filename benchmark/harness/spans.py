"""The program's own spans and counters in a run of a per-frame cell.

The program times its per-frame path in nested spans (its
``StageTimer``'s ``totals`` and ``counts``: ``frame``, ``upload``,
``labels``, each wait as ``<stage>.readback``, the sharded view's
``match.shard<s>``), opens each as a ``torch.profiler`` range named
``fire.<span>`` while a profiler records, and counts the CUDA graphs it
captures (``fire_tpu_torch.runtime.graphs.captures``).  From a run this
module takes:

* per frame, the change of every timer entry the window does not keep
  (``record["spans_ms"]``, ``record["counts"]``) and the captures made
  in the measured window (``record["captures"]``);
* from a traced run, each query's slowest shard on its card
  (``record["trace"]["shard_ms"]``, from the profiler's ranges on the
  cards) and the first card's idle time split over the program's spans
  (``record["trace"]["idle_by_span_s"]``): each idle interval is divided
  among the innermost program spans open across it, the rest is
  :data:`OUTSIDE`.

A program without these spans or counters leaves those keys out, and
their readers read nothing.

``python3 benchmark/harness/spans.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs ``benchmark/run.py`` with this added
(:func:`install`) and prints, as the last line of standard output, the
metrics these keys feed (``SPAN_METRICS``) and what the program's spans
say of the run (``info``).
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

PREFIX = "fire."  # the program's profiler ranges: PREFIX + span name
STAGES = ("detection", "tracker", "encoding", "match")  # kept by the window already
TOP = ("upload", "detection", "tracker", "labels", "encoding", "match")  # tile a frame
OUTSIDE = "outside the program"
SPAN_METRICS = ("upload_ms.frame", "labels_ms.frame", "waits_ms.frame", "waits.frame",
                "match_shard_ms.newtrack")

Interval = Tuple[float, float]


def _captures() -> Optional[int]:
    from fire_tpu_torch.runtime import graphs

    return getattr(graphs, "captures", None)


def frame_record(deltas: List[dict], n: int) -> dict:
    """Record keys from each frame's ``(totals, counts, captures)``
    changes, over the first ``n`` frames (the measured window)."""
    window = deltas[:n]
    names = sorted({k for d in window for k in d["totals"]} - set(STAGES))
    counts = sorted({k for d in window for k in d["counts"]})
    if not names:
        return {}
    caps = [d["captures"] for d in window]
    return {"spans_ms": {k: [d["totals"].get(k, 0.0) * 1e3 for d in window] for k in names},
            "counts": {k: [d["counts"].get(k, 0) for d in window] for k in counts},
            "captures": None if None in caps else int(sum(caps))}


def keep_frames(window):
    """``drive.window_per_frame`` that also keeps each frame's change of
    the timer's totals and counts and of the capture count
    (``res["program"]``, one entry a call, traced frames included)."""

    def window_per_frame(system, loop, rec, seconds, tracer, trace_frames):
        fr = system.rec
        timer, call = fr.timer, fr.recognize_faces
        deltas: List[dict] = []

        def recognize_faces(image, *a, **k):
            totals, counts, caps = dict(timer.totals), dict(getattr(timer, "counts", {})), \
                _captures()
            try:
                return call(image, *a, **k)
            finally:
                after = _captures()
                deltas.append({
                    "totals": {n: v - totals.get(n, 0.0) for n, v in timer.totals.items()
                               if v != totals.get(n, 0.0)},
                    "counts": {n: v - counts.get(n, 0)
                               for n, v in getattr(timer, "counts", {}).items()
                               if v != counts.get(n, 0)},
                    "captures": None if caps is None else after - caps})

        fr.recognize_faces = recognize_faces
        try:
            res = window(system, loop, rec, seconds, tracer, trace_frames)
        finally:
            del fr.recognize_faces
        res["program"] = deltas
        return res

    return window_per_frame


# -- the trace ----------------------------------------------------------------


def program_spans(events) -> List[Tuple[float, float, str]]:
    """(start, end, span name) of the program's ranges on the host (µs)."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):]) for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]


def first_card_gaps(events) -> List[Interval]:
    """The first card's idle intervals (µs): between its kernel and copy
    intervals, taken as ``trace.summarize`` takes them."""
    from torch.autograd import DeviceType

    from harness import trace

    by_card: Dict[int, List[Interval]] = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and e.name not in trace.SPANS):
            by_card.setdefault(int(e.device_index), []).append(
                (e.time_range.start, e.time_range.end))
    if not by_card:
        return []
    _, merged = trace._union(by_card[min(by_card)])
    return [(end, start) for (_, end), (start, _) in zip(merged, merged[1:]) if start > end]


def innermost(spans: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Properly nested spans as disjoint pieces in time order, each piece
    named by the innermost span open over it."""
    pieces, stack, t = [], [], None
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            pieces.append((t, end, inner))
            t = end
        if stack:
            pieces.append((t, a, stack[-1][1]))
        stack.append((b, name))
        t = a
    while stack:
        end, inner = stack.pop()
        pieces.append((t, end, inner))
        t = end
    return [p for p in pieces if p[1] > p[0]]


def split_gaps(gaps: List[Interval], spans: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Each gap's length divided among the innermost spans open over its
    parts; the parts with none open go to :data:`OUTSIDE` (same unit as
    the intervals)."""
    pieces = innermost(spans)
    out: Dict[str, float] = {}
    j = 0
    for a, b in sorted(gaps):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + (hi - lo)
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a - covered)
    return out


def shard_ms(events, name: str = "match.shard") -> List[float]:
    """Per query, the slowest shard's extent on its card (ms): each
    ``fire.<name><s>`` range on a card belongs to the host range of that
    shard opened last before it began (a query opens each shard once)."""
    from torch.autograd import DeviceType

    host: Dict[str, List[float]] = {}
    card: Dict[str, List[Interval]] = {}
    for e in events:
        if e.name.startswith(PREFIX + name):
            side = host if e.device_type == DeviceType.CPU else card
            side.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return extents(host, card)


def extents(host: Dict[str, List[Interval]], card: Dict[str, List[Interval]]) -> List[float]:
    """:func:`shard_ms`'s arithmetic on host and card intervals (µs) by
    range name."""
    spans: Dict[Tuple[str, int], Interval] = {}
    for name, ranges in card.items():
        starts = sorted(a for a, _ in host.get(name, []))
        for a, b in ranges:
            q = bisect.bisect_right(starts, a) - 1
            if q >= 0:
                lo, hi = spans.get((name, q), (a, b))
                spans[(name, q)] = (min(lo, a), max(hi, b))
    slowest: Dict[int, float] = {}
    for (_, q), (a, b) in spans.items():
        slowest[q] = max(slowest.get(q, 0.0), b - a)
    return [slowest[q] / 1e3 for q in sorted(slowest)]


def trace_record(prof) -> dict:
    """``shard_ms`` and ``idle_by_span_s`` of a finished profiler run."""
    events = list(prof.events())
    spans = program_spans(events)
    if not spans:
        return {}
    split = split_gaps(first_card_gaps(events), spans)
    return {"shard_ms": shard_ms(events),
            "idle_by_span_s": {k: v / 1e6 for k, v in sorted(split.items(), key=lambda kv: -kv[1])}}


# -- the run ------------------------------------------------------------------

LAST: dict = {}  # the metrics and info of the last record made with install()


def info(r: dict, deltas: List[dict], loop_idx: List[int]) -> dict:
    """What the program's spans say of a run: each span's median per
    frame, the frame span's own time
    (what no top-level span covers) and ``host_other_ms.frame`` less the
    upload and the labels, the idle split and its share outside every
    span, the captures, and the frame span with the profiler recording
    against the same loop frames in the window."""
    import numpy as np

    out: dict = {"captures_window": r.get("captures")}
    s = r.get("spans_ms")
    if s and "frame" in s:
        n = len(s["frame"])
        st = r["stages_ms"]
        top = [sum((s.get(k) or st.get(k) or [0.0] * n)[i] for k in TOP) for i in range(n)]
        out["spans_ms_p50"] = {k: float(np.median(v)) for k, v in s.items()}
        out["frame_self_ms_p50"] = float(np.median([f - t for f, t in zip(s["frame"], top)]))
        other = [lat - sum(st[k][i] for k in STAGES) for i, lat in enumerate(r["latency_ms"])]
        out["host_other_less_upload_labels_ms"] = float(
            np.median(other) - np.median(s["upload"]) - np.median(s["labels"]))
        traced = [(i, d) for i, d in enumerate(deltas) if i >= n and "frame" in d["totals"]]
        if traced:
            same = {}
            for i in range(n):
                same.setdefault(loop_idx[i], []).append(s["frame"][i])
            pairs = [(d["totals"]["frame"] * 1e3, float(np.median(same[loop_idx[i]])))
                     for i, d in traced if loop_idx[i] in same]
            if pairs:
                out["profiled_frame_ms_p50"] = float(np.median([p for p, _ in pairs]))
                out["same_frames_unprofiled_ms_p50"] = float(np.median([u for _, u in pairs]))
            out["captures_traced"] = sum(d["captures"] or 0 for _, d in traced)
    t = r.get("trace") or {}
    if t.get("idle_by_span_s"):
        split = t["idle_by_span_s"]
        total = sum(split.values())
        out["idle_by_span_s"] = split
        out["idle_outside_share"] = split.get(OUTSIDE, 0.0) / total if total else None
    return out


def keep_record(record):
    """``cell._record`` that adds the keys above to the record and keeps
    the span metrics and :func:`info` in :data:`LAST`."""

    def _record(mode, cfg, mix, loop, res, rec, tracer, setup_s, macs):
        from harness import spec

        r = record(mode, cfg, mix, loop, res, rec, tracer, setup_s, macs)
        deltas = res.get("program", [])
        r.update(frame_record(deltas, int(res["measured"])))
        if tracer.prof is not None and r["trace"] is not None:
            r["trace"].update(trace_record(tracer.prof))
        LAST.clear()
        LAST["metrics"] = {}
        for name in SPAN_METRICS:
            v = spec.reader(name)(r)
            if v is not None:
                LAST["metrics"][name] = v
        LAST["info"] = info(r, deltas, res.get("loop_idx", []))
        return r

    return _record


def install(setattr=setattr) -> None:
    """Put :func:`keep_frames` and :func:`keep_record` in the harness's
    place (``setattr`` may be a test's ``monkeypatch.setattr``)."""
    from harness import cell, drive

    setattr(drive, "window_per_frame", keep_frames(drive.window_per_frame))
    setattr(cell, "_record", keep_record(cell._record))


def main(argv=None) -> int:
    t_start = time.perf_counter()
    argv = list(sys.argv[1:] if argv is None else argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    import run
    from harness import spec

    run.T_START = t_start
    bench = spec.load_benchmark(ROOT)
    w = spec.cell(bench, argv[argv.index("--workload") + 1])
    run._env(int(spec.config(bench, w["config"], ROOT)["host_threads"]))
    install()
    rc = run.main(argv)
    if rc == 0:
        print(json.dumps({"spans": LAST}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
