"""Every metric reader's arithmetic on a recorded run, the roofline
bounds and FLOP counts from shapes, and the metric lists of the cells."""

import numpy as np
import pytest
import torch

from harness import spec, work

BENCH = spec.load_benchmark()
TRACE = {"window_s": 2.0, "busy_s": 0.5, "busy_first_s": 0.8, "k1_s": 0.004,
         "k1_bound_s": 0.001, "k2_s": 0.01, "k2_bound_s": 1e-6}
WORK = {"detector_macs": 10**9, "encoder_macs": 2 * 10**9, "frames": 640, "faces": 5000,
        "gallery_rows": 100_000, "dim": 512, "batch": 64, "encode_k": 8, "tracks": 64}


def batched(trace=None):
    return {"mode": "batched", "setup_s": 20.0, "window_s": 2.0, "measured": 640,
            "timer_ms": {"stack (host)": 1000.0, "submit (H2D + step)": 500.0,
                         "host stream_results": 200.0, "step (graph replay)": 300.0},
            "timed_batches": 10, "work": WORK, "trace": trace}


def per_frame(trace=None):
    lat = [float(x) for x in range(1, 101)]
    enc = [0.0] * 80 + [2.0] * 20
    return {"mode": "per_frame", "setup_s": 30.0, "window_s": 1.0, "measured": 100,
            "latency_ms": lat, "work": WORK, "trace": trace,
            "stages_ms": {"detection": [0.5] * 100, "tracker": [0.25] * 100,
                          "encoding": enc, "match": [0.0] * 80 + [1.0] * 20}}


def read(name, record):
    return spec.reader(name)(record)


def test_batched_readers():
    r = batched(TRACE)
    assert read("frames_per_s", r) == 320.0
    assert read("setup_s", r) == 20.0
    assert read("host_stage_ms.batch", r) == 150.0
    assert read("stream_results_ms.batch", r) == 20.0
    assert read("step_replay_ms.batch", r) == 30.0
    flops = 2.0 * (1e9 * 640 + 2e9 * 5000 + 5000 * 100_000 * 512)
    assert read("step_mfu.batch", r) == pytest.approx(100 * flops / 2.0 / 989e12)
    assert read("k1_roofline.batch", r) == pytest.approx(25.0)
    assert read("k2_roofline.batch", r) == pytest.approx(0.01)
    assert read("device_idle.batch", r) == pytest.approx(75.0)
    for name in ("frame_ms_p50", "detect_ms.frame", "device_idle.frame"):
        assert read(name, r) is None


def test_per_frame_readers():
    r = per_frame(TRACE)
    assert read("frame_ms_p50", r) == pytest.approx(50.5)
    assert read("frame_ms_p95", r) == pytest.approx(np.percentile(range(1, 101), 95))
    assert read("detect_ms.frame", r) == 0.5
    assert read("tracker_ms.frame", r) == 0.25
    other = [t - 0.75 - (3.0 if i >= 80 else 0.0) for i, t in enumerate(range(1, 101))]
    assert read("host_other_ms.frame", r) == pytest.approx(np.median(other))
    assert read("encode_ms.newtrack", r) == 2.0
    assert read("match_ms.newtrack", r) == 1.0
    assert read("device_idle.frame", r) == pytest.approx(60.0)
    for name in ("frames_per_s", "k1_roofline.batch", "step_mfu.batch"):
        assert read(name, r) is None


def test_readers_find_nothing_without_a_trace():
    for name in ("k1_roofline.batch", "k2_roofline.batch", "device_idle.batch"):
        assert read(name, batched()) is None
    assert read("device_idle.frame", per_frame()) is None
    # a trace with no device time is not read as a share of anything
    empty = dict(TRACE, busy_s=0.0, busy_first_s=0.0, k1_s=0.0, k2_s=0.0)
    for name in ("k1_roofline.batch", "k2_roofline.batch", "device_idle.batch"):
        assert read(name, batched(empty)) is None


def test_every_cell_reports_its_metrics():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for w in BENCH["workloads"]:
        e2e = spec.metrics_of(BENCH, w["name"], "end_to_end")
        layer = spec.metrics_of(BENCH, w["name"], "per_layer")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        reported = {m["name"] for m in e2e}
        assert all(m["moves"] in reported for m in layer)
    for n in names:
        spec.reader(n)  # every metric has its reader


def test_read_metrics_leaves_out_what_is_missing():
    out = spec.read_metrics(BENCH, "yunet640-facenet512-g100k.live", "per_layer", per_frame())
    assert "device_idle.frame" not in out and out["detect_ms.frame"]["unit"] == "ms"


def test_k1_bound_from_shapes():
    # 99,900 bf16 rows of 512 read once dominate at one query: bytes-bound
    t = work.k1_bound_s(1, 99_900, 512)
    assert t == pytest.approx((99_900 * 1024 + 1024 + 8) / 3.35e12)
    # 512 queries: 2·M·N·D operations at the bf16 rate are the larger
    t = work.k1_bound_s(512, 99_900, 512)
    assert t == pytest.approx(2.0 * 512 * 99_900 * 512 / 989e12)


def test_k2_bound_from_shapes():
    b, t, k = 64, 64, 8
    table = t * 110 * 4 + t * 5 * 4 + t + 4
    nbytes = b * k * 17 + 2 * table + b * t * 29 + b * k * 9 + 2 * t * 13 + b * t * 13
    assert work.k2_bound_s(b, t, k) == pytest.approx(nbytes / 3.35e12)


def test_macs_from_shapes_match_the_program_count():
    """The benchmark's count on its reference networks equals the
    program's own counting rule on the program's modules."""
    from fire_tpu_torch.bench.common import forward_macs
    from fire_tpu_torch.models.facenet import FaceNet
    from fire_tpu_torch.models.retinaface import RetinaFace
    from fire_tpu_torch.models.yunet import YuNet

    got = work.network_macs("yunet", (640, 640))
    with torch.device("meta"):
        y = forward_macs(YuNet(), torch.empty(1, 640, 640, 3))
        f = forward_macs(FaceNet(512), torch.empty(1, 160, 160, 3))
        r = forward_macs(RetinaFace(), torch.empty(1, 512, 512, 3))
    assert got == {"detector": y, "encoder": f}
    assert work.network_macs("retinaface", (512, 512))["detector"] == r
    assert 0.5e9 < y < 5e9 and 1e9 < f < 3e9
