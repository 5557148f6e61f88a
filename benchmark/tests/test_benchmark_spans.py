"""The program's spans in a run (``harness/spans.py``): the readers of
the span metrics on a synthetic record, and nothing read from a record
without them; the idle split and the shards' extents on synthetic
intervals; a CPU run of a cell with the spans kept; and on the card, a
traced gate whose device operations hold none of the program's ranges
(``cuda``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cpu_cell import run_cpu
from harness import spans, spec


def read(name, record):
    return spec.reader(name)(record)


def record(trace=None):
    """Four frames: the second and fourth encode a new face and query the
    gallery (two waits); the fourth also enrols."""
    return {"mode": "per_frame", "setup_s": 1.0, "window_s": 1.0, "measured": 4,
            "latency_ms": [4.0, 7.0, 4.0, 9.0], "work": {}, "trace": trace,
            "stages_ms": {"detection": [2.0] * 4, "tracker": [0.3] * 4,
                          "encoding": [0.0, 2.5, 0.0, 2.5], "match": [0.0, 0.4, 0.0, 0.5]},
            "spans_ms": {"frame": [3.9, 6.9, 3.9, 8.9], "upload": [0.5, 0.6, 0.7, 0.8],
                         "labels": [0.2, 0.3, 0.2, 1.2], "labels.enrol": [0, 0, 0, 0.9],
                         "detection.readback": [0.2] * 4, "tracker.readback": [0.1] * 4,
                         "encoding.readback": [0.0, 0.4, 0.0, 0.4],
                         "match.readback": [0.0, 0.2, 0.0, 0.3]},
            "counts": {"frame": [1] * 4, "upload": [1] * 4, "labels": [2] * 4,
                       "detection.readback": [1] * 4, "tracker.readback": [1] * 4,
                       "encoding.readback": [0, 1, 0, 1], "match.readback": [0, 2, 0, 2]},
            "captures": 0}


def test_span_readers():
    r = record({"window_s": 1.0, "busy_first_s": 0.5, "shard_ms": [0.3, 0.5, 0.2]})
    assert read("upload_ms.frame", r) == pytest.approx(0.65)
    assert read("labels_ms.frame", r) == pytest.approx(0.25)
    assert read("waits_ms.frame", r) == pytest.approx(np.median([0.3, 0.9, 0.3, 1.0]))
    assert read("waits.frame", r) == pytest.approx((2 + 5 + 2 + 5) / 4)
    assert read("match_shard_ms.newtrack", r) == pytest.approx(0.3)
    # the accepted readers read what they read before
    assert read("host_other_ms.frame", r) == pytest.approx(np.median([1.7, 1.8, 1.7, 3.7]))


def test_span_readers_read_nothing_without_the_spans():
    """A program without the spans (the parent of the change) gives a
    record without the keys: no value, no error."""
    r = record({"window_s": 1.0, "busy_first_s": 0.5})
    for k in ("spans_ms", "counts", "captures"):
        del r[k]
    for name in spans.SPAN_METRICS:
        assert read(name, r) is None
    assert read("match_shard_ms.newtrack", record()) is None
    batched = {"mode": "batched", "trace": None}
    for name in spans.SPAN_METRICS:
        assert read(name, batched) is None


def test_a_gap_is_split_over_the_spans_open_across_it():
    frame = [(0, 100, "frame"), (0, 10, "upload"), (10, 40, "detection"),
             (35, 40, "detection.readback"), (40, 60, "tracker"), (60, 90, "labels")]
    gaps = [(5, 15), (30, 45), (95, 120), (130, 140)]
    got = spans.split_gaps(gaps, frame)
    # (5, 15): upload 5, detection 5; (30, 45): detection 5, its readback 5,
    # tracker 5; (95, 120): the frame's own 5, then 20 outside every span
    assert got == {"upload": 5, "detection": 10, "detection.readback": 5, "tracker": 5,
                   "frame": 5, spans.OUTSIDE: 30}
    assert sum(got.values()) == sum(b - a for a, b in gaps)
    assert spans.split_gaps([(0, 10)], []) == {spans.OUTSIDE: 10}


def test_innermost_pieces_of_nested_spans():
    pieces = spans.innermost([(0, 10, "a"), (2, 8, "b"), (3, 4, "c"), (12, 14, "d")])
    assert pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 8, "b"), (8, 10, "a"),
                      (12, 14, "d")]


def test_each_query_takes_its_slowest_shard():
    host = {"fire.match.shard0": [(0, 5), (100, 104)],
            "fire.match.shard1": [(5, 9), (104, 108)]}
    card = {"fire.match.shard0": [(10, 40), (110, 120)],
            "fire.match.shard1": [(12, 30), (111, 150), (151, 160)]}
    # query 0: shard 0 30 µs; query 1: shard 1 from 111 to 160
    assert spans.extents(host, card) == pytest.approx([0.030, 0.049])
    assert spans.extents({}, card) == []


def test_frame_record_keeps_the_window():
    deltas = [{"totals": {"frame": 0.004, "detection": 0.002, "upload": 0.001},
               "counts": {"frame": 1, "detection.readback": 1}, "captures": 0},
              {"totals": {"frame": 0.005, "labels.enrol": 0.001},
               "counts": {"frame": 1}, "captures": 1},
              {"totals": {"frame": 0.009}, "counts": {"frame": 1}, "captures": 3}]
    got = spans.frame_record(deltas, 2)
    assert got["spans_ms"] == {"frame": [4.0, 5.0], "labels.enrol": [0.0, 1.0],
                               "upload": [1.0, 0.0]}
    assert got["counts"] == {"detection.readback": [1, 0], "frame": [1, 1]}
    assert got["captures"] == 1
    assert spans.frame_record([{"totals": {"detection": 0.1}, "counts": {},
                                "captures": None}], 1) == {}


def test_a_cpu_run_keeps_the_program_spans(monkeypatch):
    spans.install(monkeypatch.setattr)
    out = run_cpu("yunet640-facenet512-g100k.live", seconds=3.0, trace=True)
    assert out["correct"] is True
    got = spans.LAST
    for name in ("upload_ms.frame", "labels_ms.frame", "waits_ms.frame", "waits.frame"):
        assert got["metrics"][name] > 0, name
    # detect and the tracker wait once a frame, a frame that encodes three more times
    assert 2.0 <= got["metrics"]["waits.frame"] < 5.0
    assert "match_shard_ms.newtrack" not in got["metrics"]  # one card, no trace of a card
    assert got["info"]["captures_window"] == 0
    assert 0 <= got["info"]["frame_self_ms_p50"] < 1.0
    # the accepted metrics are read as before, beside them
    assert {"detect_ms.frame", "host_other_ms.frame"} <= set(out["metrics"])


@pytest.mark.cuda
def test_a_traced_gate_shows_no_program_range_as_device_work():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "harness", "spans.py"),
                        "--workload", "yunet640-facenet512-g100k.live", "--seed", "2718281828",
                        "--seconds", "4", "--trace", "1"], capture_output=True, text=True,
                       cwd=spec.ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    out, got = json.loads(lines[-2]), json.loads(lines[-1])["spans"]
    print(json.dumps({"breakdown": out["breakdown"], "spans": got}))
    assert out["correct"] is True
    assert not [n for n, _ in out["breakdown"]["device_ops"] if n.startswith(spans.PREFIX)]
    assert not [n for n, _ in out["breakdown"]["idle_gaps"] if n.startswith(spans.PREFIX)]
    assert got["info"]["captures_window"] == 0
    assert set(got["metrics"]) >= {"upload_ms.frame", "labels_ms.frame", "waits_ms.frame",
                                   "waits.frame"}
    assert got["info"]["idle_by_span_s"]
