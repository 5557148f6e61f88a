"""The per-frame path's graphs (``DeviceEngine`` detect / encode and
``Sort.update`` replayed per key, ``runtime/graphs.py``) held on the CPU
against the JAX package: what JAX jits and how it pads, the keys it
compiles under, and the plumbing around a replay.  The graphs themselves
are captured on the card only (``tests/test_torch_frame_graph_cuda.py``).

* ``_buckets`` equals JAX's for n = 0…40 at caps 16 and 8.
* ``encode_boxes`` / ``encode_landmarks`` / ``encode_faces`` at k = 1, 3,
  16, 17 and 40 (bucket padding and the slice recursion) against the JAX
  engine's same calls: cosine ≥ 0.9999, as ``test_torch_engine_frame.py``
  states it.
* With the capture replaced by a stand-in that keeps the static inputs
  and runs the function on them at each replay (``FakeCall``), the graph
  path's plumbing runs here: its keys equal JAX's ``_detect_jit_cache``
  keys for the same calls, the landmark pad rows hold the template and
  no row is NaN, ``Sort`` keeps its table in place, and
  ``recognize_faces`` over 24 seeded frames equals JAX's
  ``FaceRecognition`` (boxes ±1 px, confidences 1e-3, labels up to a
  bijection, as ``test_torch_frame_path.py`` holds it) on both paths.
* On a CPU device nothing is captured.
"""

import numpy as np
import pytest
import torch

from fire_tpu.config import TrackerConfig as JTrackerConfig
from fire_tpu.pipeline.engine import _buckets as j_buckets
from fire_tpu.track.sort import Sort as JSort
from fire_tpu_torch.config import ALIGN_TEMPLATE_160, TrackerConfig
from fire_tpu_torch.pipeline import engine as TE
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.runtime import graphs
from fire_tpu_torch.track import sort as TS
from tests.test_torch_engine_frame import engines, scenes
from tests.test_torch_frame_path import BLANK, _pair, _same_faces, _same_store, _scenes
from tests.test_torch_sort_host import script

KS = [1, 3, 16, 17, 40]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These tests run beside other workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return engines("yunet")


class FakeCall:
    """Stands in for ``CapturedCall`` where there is no card: it keeps
    the static inputs and state it is given and runs ``fn`` on them at
    each replay (nothing is captured)."""

    built = []

    def __init__(self, fn, inputs, pool, state=()):
        self.fn, self.inputs, self.state = fn, tuple(inputs), tuple(state)
        self.replays = 0
        FakeCall.built.append(self)

    def replay(self):
        self.replays += 1
        with torch.no_grad():
            out = self.fn(*self.inputs, *self.state)
        self.outputs = out if isinstance(out, tuple) else (out,)
        return self.outputs


@pytest.fixture
def graph_path(monkeypatch):
    """The card's path on the CPU: ``_graphed`` true for the engine and
    the tracker, the capture replaced by :class:`FakeCall`."""
    FakeCall.built = []
    monkeypatch.setattr(graphs, "CapturedCall", FakeCall)
    monkeypatch.setattr(graphs, "_new_pool", lambda: None)
    monkeypatch.setattr(DeviceEngine, "_graphed", lambda self, device: True)
    monkeypatch.setattr(TS.Sort, "_graphed", lambda self, device: True)
    return FakeCall.built


def _cos(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


def _rows(kind, k, seed):
    rng = np.random.default_rng(seed)
    if kind == "boxes":
        xy = rng.uniform(-10, 220, (k, 2))
        return np.concatenate([xy, rng.uniform(30, 110, (k, 2))], 1).astype(np.float32)
    if kind == "landmarks":
        eye = rng.uniform(20, 200, (k, 1, 2))
        tri = np.array([[0, 0], [35, 2], [17, 25]], np.float32)[None]
        return (eye + tri * rng.uniform(0.7, 1.3, (k, 1, 1))).astype(np.float32)
    return rng.uniform(0, 1, (k, 160, 160, 3)).astype(np.float32)


@pytest.mark.parametrize("cap", [16, 8])
def test_buckets_equal_jax(cap):
    got = [TE._buckets(n, cap) for n in range(41)]
    assert got == [j_buckets(n, cap) for n in range(41)]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["boxes", "landmarks", "faces"])
def test_padded_encode_matches_jax(pair, kind, k):
    jeng, teng = pair
    frame = scenes(50, 1)[0]
    rows = _rows(kind, k, seed=k)
    if kind == "faces":
        j, t = jeng.encode_faces(rows), teng.encode_faces(rows)
    else:
        j = getattr(jeng, f"encode_{kind}")(frame, rows)
        t = getattr(teng, f"encode_{kind}")(frame, rows)
    assert t.shape == j.shape == (k, 128) and t.dtype == np.float32
    assert np.isfinite(t).all()
    assert _cos(j, t).min() >= 0.9999


def test_graph_keys_equal_jax_cache_keys(graph_path):
    """The same calls on both engines: the port's graph keys are the
    device, JAX's ``_detect_jit_cache`` key and the module in the slot;
    ``encode_faces`` keys its padded shape (JAX's jit of
    ``_encode_batch``)."""
    for detector in ("yunet", "mediapipe"):
        jeng, teng = engines(detector)
        jeng._detect_jit_cache.clear()
        frame = scenes(51, 1)[0]
        for eng in (jeng, teng):
            eng.detect(frame)
            eng.detect(frame, variant="extract")
            eng.detect(frame[:200])
            eng.encode_boxes(frame, _rows("boxes", 17, 1))
            eng.encode_landmarks(frame, _rows("landmarks", 3, 2))
            eng.encode_faces(_rows("faces", 5, 3))
        keys = [k for k, _ in teng.graphs]
        assert all(k[0] == torch.device("cpu") for k in keys)
        assert {k[1] for k in keys if k[1][0] != "encf"} == set(jeng._detect_jit_cache)
        assert {k[1] for k in keys if k[1][0] == "encf"} == {("encf", (8, 160, 160, 3))}
        assert {id(k[2]) for k in keys if k[1][0] in ("encb", "encl", "encf")} == {id(teng.encoder)}
        assert {id(k[2]) for k in keys if k[1][0] not in ("encb", "encl", "encf")} == \
            {id(teng.detector)}


def test_graph_path_pads_as_jax_and_copies_out(pair, graph_path):
    _, teng = pair
    teng.release_graphs()
    frame = scenes(52, 1)[0]
    lms = _rows("landmarks", 3, 4)
    t = teng.encode_landmarks(frame, lms)
    (call,) = [c for c in graph_path if len(c.inputs) == 2]
    static_frame, rows = call.inputs
    np.testing.assert_array_equal(rows[:3].numpy(), lms)
    np.testing.assert_array_equal(rows[3].numpy(), np.asarray(ALIGN_TEMPLATE_160, np.float32))
    assert np.isfinite(call.outputs[0].numpy()).all() and call.outputs[0].shape == (4, 128)
    np.testing.assert_array_equal(call.outputs[0][:3].numpy(), t)
    # the frame went into the static frame input of its size, which the
    # encode and detect graphs of that size read
    np.testing.assert_array_equal(static_frame.numpy(), frame)
    d = teng.detect(frame)
    det_call = graph_path[-1]
    assert det_call.inputs[0] is static_frame
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(d, det_call.outputs))  # copies
    # a second frame and rows of the same key replay: no new graph, the
    # new values in place
    frame2, lms2 = scenes(53, 1)[0], _rows("landmarks", 3, 5)
    n = len(graph_path)
    teng.encode_landmarks(frame2, lms2)
    assert len(graph_path) == n and call.replays == 2
    np.testing.assert_array_equal(static_frame.numpy(), frame2)
    np.testing.assert_array_equal(rows[:3].numpy(), lms2)
    np.testing.assert_array_equal(rows[3].numpy(), np.asarray(ALIGN_TEMPLATE_160, np.float32))


def test_mixed_frame_sizes_keep_every_graph(pair, graph_path):
    """As JAX's jit cache, the engine keeps every key it has seen: frames
    of nine sizes in turn (18 keys, more than one frame size's 17) capture
    once a key and replay after."""
    _, teng = pair
    teng.release_graphs()
    frame = scenes(55, 1)[0]
    hws = [(240, 320), (200, 320), (240, 240), (180, 300), (220, 260), (160, 320), (240, 200),
           (210, 310), (190, 250)]
    for _ in range(2):
        for h, w in hws:
            teng.detect_faces(frame[:h, :w])
            teng.encode_boxes(frame[:h, :w], _rows("boxes", 3, 8))
    assert len(graph_path) == len(teng.graphs) == 18 and len(teng._frames) == 9
    assert all(c.replays == 2 for c in graph_path)


def test_caller_frames_are_copied_not_bound(pair, graph_path):
    """A frame handed in as a tensor goes into the engine's static frame
    input of its size: no graph keeps the caller's tensor, and a later
    frame of that size leaves the earlier one as it was."""
    _, teng = pair
    teng.release_graphs()
    video = torch.from_numpy(np.stack(scenes(56, 2)))
    kept = video.clone()
    rows = _rows("boxes", 2, 9)
    for i in (0, 1, 0):
        teng._graphed = lambda device: False  # the plain version
        want = teng.encode_boxes(video[i].numpy().copy(), rows)
        del teng._graphed
        np.testing.assert_array_equal(teng.encode_boxes(video[i], rows), want)
        teng.detect(video[i])
        assert torch.equal(video, kept)
    static = teng._frames[tuple(video.shape[1:3])]
    assert all(a is static for c in graph_path for a in c.inputs[:1])
    assert static.data_ptr() not in {video[i].data_ptr() for i in range(2)}
    assert teng.to_device(static) is static


def test_nothing_is_captured_on_the_cpu(pair, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(graphs, "CapturedCall", refuse)
    _, teng = pair
    teng.release_graphs()
    frame = scenes(54, 1)[0]
    teng.detect_faces(frame)
    teng.encode_boxes(frame, _rows("boxes", 3, 5))
    teng.encode_landmarks(frame, _rows("landmarks", 2, 6))
    teng.encode_faces(_rows("faces", 2, 7))
    tracker = TS.Sort(TrackerConfig(max_tracks=16), max_dets=8, device="cpu")
    tracker.update([{"bbox": [10, 10, 40, 40]}])
    assert len(teng.graphs) == 0 and len(tracker.graphs) == 0 and not teng._frames


@pytest.mark.parametrize("plumbing", ["eager", "graph"])
@pytest.mark.parametrize("assignment", ["hungarian", "greedy", "hungarian_host"])
def test_sort_keeps_its_table_and_matches_jax(request, assignment, plumbing):
    """Every frame writes the table into its own tensors, on either path,
    and ``reset()`` writes a fresh table into them (same ``data_ptr``)."""
    built = request.getfixturevalue("graph_path") if plumbing == "graph" else None
    js = JSort(JTrackerConfig(assignment=assignment, max_tracks=16), max_dets=8)
    ts = TS.Sort(TrackerConfig(assignment=assignment, max_tracks=16), max_dets=8, device="cpu")
    before = [(t, t.data_ptr()) for t in ts.table]
    for rnd in range(2):
        for f, dets in enumerate(script(6 + rnd)):
            j, t = js.update(dets), ts.update(dets)
            assert [d["id"] for d in t] == [d["id"] for d in j], (rnd, f)
            for a, b in zip(j, t):
                assert a["age"] == b["age"] and a["src_det"] == b["src_det"], (rnd, f)
                assert np.abs(np.subtract(a["bbox"], b["bbox"])).max() <= 1, (rnd, f)
        assert bool(ts.table.active.any())
        for (t, ptr), now in zip(before, ts.table):
            assert now is t and now.data_ptr() == ptr
        ts.reset()
        js.reset()
        fresh = TS.make_table(ts.cfg, "cpu")
        for (t, ptr), now, want in zip(before, ts.table, fresh):
            assert now is t and now.data_ptr() == ptr and torch.equal(now, want)
    if built is not None:
        names = sorted(k[-1] for k, _ in ts.graphs)
        assert names == (["apply", "predict"] if assignment == "hungarian_host" else ["step"])
        assert all(a is b for c in built for a, b in zip(c.state, ts.table))


@pytest.mark.parametrize("plumbing", ["eager", "graph"])
def test_recognize_faces_24_frames_matches_jax(tmp_path, request, plumbing):
    if plumbing == "graph":
        request.getfixturevalue("graph_path")
    jfr, tfr = _pair(tmp_path, align_video=True)
    tfr.engine.release_graphs()
    a, b = _scenes(61, 2)
    frames = [a] * 6 + [BLANK] * 6 + [b] * 6 + [a] * 6
    label_map = {"Unknown": "Unknown"}
    for f, frame in enumerate(frames):
        _same_faces(jfr.recognize_faces(frame), tfr.recognize_faces(frame), label_map, f)
    assert len(set(label_map.values())) == len(label_map) > 1
    assert jfr.counters == tfr.counters and tfr.counters["unknown_enrolled"] > 0
    kinds = {k[1][0] if isinstance(k[1][0], str) else "detect" for k, _ in tfr.engine.graphs}
    if plumbing == "graph":  # a track spawned by this frame's detection takes aligned crops
        assert kinds >= {"detect", "encl"} and len(tfr.face_tracker.graphs) == 1
    else:
        assert not kinds
    jfr.close(), tfr.close()
    # close releases the tracker's graphs; the engine was given by the
    # caller, whose graphs it keeps
    assert len(tfr.face_tracker.graphs) == 0
    assert (len(tfr.engine.graphs) > 0) == (plumbing == "graph")
    tfr.engine.release_graphs()
    _same_store(tmp_path, jfr, tfr, label_map)
