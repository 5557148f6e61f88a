"""The per-frame path's spans and counters: ``StageTimer.span``'s
totals, counts and nesting; its ``fire.``-prefixed ranges on a
``torch.profiler`` timeline, only while one records; the names apart
from the benchmark's own spans; a ``recognize_faces`` run on the CPU
(trained YuNet at 320², a tiny FaceNet, 240×320 rendered frames) timed
by spans that tile the frame, one ``readback`` span a wait; the sharded
view's query shard by shard; and the graph captures a steady loop makes
(none)."""

import functools
import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.pipeline import engine as TE
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.pipeline.recognizer import FaceRecognition
from fire_tpu_torch.pipeline.timing import PREFIX, StageTimer, span
from fire_tpu_torch.runtime import graphs
from fire_tpu_torch.track import sort as TS
from fire_tpu_torch.train.scenes import compose_scene, make_identities

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WT = os.path.join(REPO, "weights_trained")
EKW = dict(detect_size=(320, 320), compute_dtype="float32", strict_f32_preprocess=True)
# the top-level spans of a frame, which tile it
TOP = ("upload", "detection", "tracker", "labels", "encoding", "match")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _engine():
    cfg = RecognizerConfig(detector_type="yunet", engine=EngineConfig(**EKW)).with_embedding_dim()
    eng = DeviceEngine(cfg, device="cpu", encoder=tiny_facenet(128))
    eng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    return eng


def _recognizer(tmp_path, **kw):
    args = dict(detector_type="yunet", encoder_model_type="128", similarity_threshold=0.7,
                unknown_trigger_count=1, enable_logging=False, detection_interval=1)
    args.update(kw)
    return FaceRecognition(**args, storage_root=str(tmp_path), engine=_engine())


def _frames(interval):
    idents = make_identities(6, seed=31)
    rng = np.random.default_rng(32)
    a, b = (compose_scene(rng, idents, hw=(240, 320), n_faces=(1, 2), face_px=(70, 150),
                          occlusion_prob=0.0)[0] for _ in range(2))
    blank = np.zeros_like(a)
    # blank stretches outlast max_age, so scene b starts new tracks
    return [f for f in [a] * 5 + [blank] * 6 + [b] * 5 for _ in range(interval)]


def _trace_module():
    spec = importlib.util.spec_from_file_location(
        "bench_trace", os.path.join(REPO, "benchmark", "harness", "trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_totals_counts_and_nesting():
    t = StageTimer()
    for _ in range(2):
        with t.span("frame", frame=1):
            with t.span("match"):
                time.sleep(0.002)
                with t.span("readback"):
                    time.sleep(0.001)
                with t.span("readback"):
                    pass
            with t.span("labels"):
                with t.span("enrol"):
                    pass
    assert t.counts == {"frame": 2, "match": 2, "match.readback": 4, "labels": 2,
                        "labels.enrol": 2}
    assert set(t.totals) == set(t.counts)
    assert t.totals["match.readback"] >= 0.002
    assert t.totals["match"] >= t.totals["match.readback"] + 0.004
    assert t.totals["frame"] >= t.totals["match"] + t.totals["labels"]
    # a span that raises still closes, and the next one is top-level again
    with pytest.raises(ValueError):
        with t.span("detection"):
            raise ValueError
    with t.span("upload"):
        pass
    assert t.counts["detection"] == 1 and t.counts["upload"] == 1


def test_a_component_span_nests_in_the_open_span():
    with span("readback"):  # outside every span: nothing
        pass
    t, other = StageTimer(), StageTimer()
    with t.span("match"):
        with span("readback"):
            pass
        with other.span("frame", frame=1):  # a span of another timer is innermost
            with span("upload"):
                pass
        with span("readback"):
            pass
    assert t.counts == {"match": 1, "match.readback": 2}
    assert other.counts == {"frame": 1, "upload": 1}


def test_spans_are_profiler_ranges_only_while_one_records():
    t = StageTimer()
    with t.span("frame", frame=5) as s:
        assert s.range is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        with t.span("frame", frame=6):
            with t.span("match"):
                with t.span("readback"):
                    torch.ones(2).sum()
    with t.span("match"):
        pass
    ranges = [e for e in prof.events() if e.name.startswith(PREFIX)]
    assert [e.name for e in ranges] == ["fire.frame", "fire.match", "fire.match.readback"]
    assert all(e.is_user_annotation for e in ranges)
    assert ranges[0].concrete_inputs == [6]  # the frame index
    assert ranges[2].cpu_parent is ranges[1] and ranges[1].cpu_parent is ranges[0]
    assert t.counts == {"frame": 2, "match": 2, "match.readback": 1}


def test_program_span_names_are_not_the_benchmark_spans(tmp_path):
    fr = _recognizer(tmp_path, sharded_gallery=True)
    for frame in _frames(1):
        fr.recognize_faces(frame)
    names = {PREFIX + n for n in fr.timer.totals}
    spans = _trace_module().SPANS
    assert not names & set(spans)
    assert not any(s.startswith(PREFIX) for s in spans)
    assert {"fire.match.shard0", "fire.match.readback", "fire.frame"} <= names


@pytest.mark.parametrize("sharded", [False, True], ids=["gallery", "sharded_view"])
@pytest.mark.parametrize("interval", [1, 3])
def test_recognize_faces_spans_tile_the_frame(tmp_path, interval, sharded):
    fr = _recognizer(tmp_path, detection_interval=interval, sharded_gallery=sharded)
    frames = _frames(interval)
    detecting = 0
    for frame in frames:
        fr.recognize_faces(frame)
        detecting += fr.frame_index % interval == 0
    t, c, n = fr.timer.totals, fr.timer.counts, len(frames)
    assert set(t) >= {"detection", "tracker", "encoding", "match", "frame", "upload", "labels",
                      "labels.enrol", "detection.readback", "tracker.readback",
                      "encoding.readback", "match.readback"}
    assert set(c) == set(t)
    assert c["frame"] == c["upload"] == c["tracker"] == c["tracker.readback"] == n
    assert c["detection"] == c["detection.readback"] == detecting
    assert c["labels"] == 2 * n
    # two waits a query (ids and sims); the first new face meets an empty gallery
    assert c["match.readback"] == 2 * (c["match"] - 1) > 0
    assert c["encoding.readback"] >= c["encoding"] > 0
    assert c["labels.enrol"] >= fr.counters["unknown_enrolled"] > 0
    assert sum(t[k] for k in TOP) <= t["frame"]
    for k in TOP:
        assert t[k] >= sum(v for name, v in t.items() if name.startswith(k + "."))
    shards = {k for k in t if k.startswith("match.shard")}
    assert shards == ({"match.shard0"} if sharded else set())
    if sharded:
        assert 2 * c["match.shard0"] == c["match.readback"]  # one a query
    assert fr.timer.frame_count == n


def test_a_steady_loop_captures_no_graph(tmp_path, monkeypatch):
    """With the capture faked on the CPU (the per-frame graphs' plumbing),
    the first frames capture each key once and a second pass over the
    same frames captures nothing."""
    from tests.test_torch_frame_graph import FakeCall

    FakeCall.built = []
    monkeypatch.setattr(graphs, "CapturedCall", FakeCall)
    monkeypatch.setattr(graphs, "_new_pool", lambda: None)
    monkeypatch.setattr(TE.DeviceEngine, "_graphed", lambda self, device: True)
    monkeypatch.setattr(TS.Sort, "_graphed", lambda self, device: True)
    fr = _recognizer(tmp_path)
    frames = _frames(1)
    before = graphs.captures
    for frame in frames:
        fr.recognize_faces(frame)
    first = graphs.captures - before
    assert first == len(FakeCall.built) > 0
    for frame in frames:
        fr.recognize_faces(frame)
    assert graphs.captures - before == first
    fr.engine.release_graphs()


def test_the_sharded_query_is_timed_shard_by_shard():
    """A view over four shards: inside ``match`` the refresh after an
    enrolment, one span a shard (its query copy and top-k), and two
    waits; the answers are those of the gallery's own query."""
    from fire_tpu_torch.gallery.index import DeviceGallery, ShardedGalleryView
    from fire_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(7)
    rows = rng.standard_normal((300, 64)).astype(np.float32)
    gallery = DeviceGallery(64, capacity=512, device="cpu")
    for i in range(200):
        gallery.add(rows[i], f"p{i}", i + 1)
    view = ShardedGalleryView(gallery, make_mesh(devices=["cpu"] * 4))
    t = StageTimer()
    for i in range(200, 300):  # enrolments after the view was built
        gallery.add(rows[i], f"p{i}", i + 1)
    with t.span("match"):
        ids, _ = view.query_batch(rows[[3, 250]], k=1)
    with t.span("match"):
        view.query_batch(rows[[4]], k=1)
    assert ids[:, 0].tolist() == [3, 250]
    assert t.counts == {"match": 2, "match.refresh": 1, "match.readback": 4,
                        **{f"match.shard{s}": 2 for s in range(4)}}
    assert t.totals["match"] >= sum(v for k, v in t.totals.items() if k.startswith("match."))
