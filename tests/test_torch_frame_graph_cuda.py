"""The per-frame path's CUDA graphs on the card (``DeviceEngine`` detect
and encode, ``Sort.update``; ``runtime/graphs.py``) against their plain
version, the same engine or tracker run eagerly.

Needs an NVIDIA card and nvcc, and skips without them.  This file
imports no JAX, so it runs on the machine with the card, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_frame_graph_cuda.py -q

Every replay is bitwise equal to the eager call on the same inputs:
detect in every slot (the committed YuNet at 320², BlazeFace at 128² and
RetinaFace at 512², the executor running the YuNet and BlazeFace graphs
exported from them), both encoder crops and
``encode_faces`` at every bucket (a module and an executor in the
encoder slot), and ``Sort`` over 64 seeded frames under each assignment,
before and after ``reset()``.  A key captures once; K2 counts one launch
a replay and nothing for the warm-up and the capture; a capture that
fails raises and nothing runs eagerly in its place.  A caller's frames on
the card are read, never bound or written, by the graphs.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from fire_tpu_torch.config import EngineConfig, RecognizerConfig, TrackerConfig
from fire_tpu_torch.models.blazeface import BlazeFace
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.models.onnx_exec import OnnxModel
from fire_tpu_torch.models.onnx_export import export_blazeface, export_facenet, export_yunet
from fire_tpu_torch.models.onnx_import import read_onnx_bytes
from fire_tpu_torch.pipeline import engine as TE
from fire_tpu_torch.runtime import graphs
from fire_tpu_torch.track import scan as k2
from fire_tpu_torch.track.sort import Sort
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.weights import flax_shapes, materialize

pytestmark = pytest.mark.cuda

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")
EKW = dict(detect_size=(320, 320), blazeface_size=(128, 128), retinaface_size=(512, 512))
SLOTS = ["yunet", "blazeface", "retinaface", "yunet-executor", "blazeface-executor"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the graphs are captured there only")
    return torch.device("cuda")


def _engine(slot: str, encoder: str = "module") -> TE.DeviceEngine:
    det = slot.split("-")[0]
    cfg = RecognizerConfig(detector_type="mediapipe" if det == "blazeface" else det,
                           weights_dir=None, engine=EngineConfig(**EKW)).with_embedding_dim()
    eng = TE.DeviceEngine(cfg, device="cuda", encoder=tiny_facenet(128))
    eng.load_trained_detector(f"{WT}/{det}_synth.msgpack")  # the committed weights
    if slot == "yunet-executor":
        graph = read_onnx_bytes(export_yunet(eng.det_vars, image_hw=EKW["detect_size"]))
        eng.detector = TE.OnnxYuNet(OnnxModel(graph, device="cuda"), eng._detect_input)
    elif slot == "blazeface-executor":
        graph = read_onnx_bytes(export_blazeface(eng.det_vars))
        eng.detector = TE.OnnxBlazeFace(OnnxModel(graph, device="cuda"))
    if encoder == "executor":
        tree = materialize(flax_shapes(tiny_facenet(128), unit_bn_scale=True), 5)
        graph = read_onnx_bytes(export_facenet(tree, embed_dim=128, depths=(1, 1, 1),
                                               stem_width=8))
        eng.encoder = TE.OnnxEncoder(OnnxModel(graph, device="cuda"))
    return eng


@contextlib.contextmanager
def _eager(owner):
    """``owner`` (an engine or a tracker) run eagerly: the plain version."""
    owner._graphed = lambda device: False
    try:
        yield
    finally:
        del owner._graphed


def _frames(seed: int, n: int, hw=(240, 320), face_px=(60, 130)):
    idents = make_identities(6, seed=seed)
    rng = np.random.default_rng(seed + 1)
    return [compose_scene(rng, idents, hw=hw, n_faces=(1, 3), face_px=face_px,
                          occlusion_prob=0.0)[0] for _ in range(n)]


@pytest.mark.parametrize("slot", SLOTS)
def test_detect_replay_equals_eager(cuda_device, slot):
    eng = _engine(slot)
    found = 0
    for variant in ("detect", "extract"):
        for frame in _frames(7, 3):
            with _eager(eng):
                want = eng.detect(frame, variant=variant)
                want_faces = eng.detect_faces(frame)
            got = eng.detect(frame, variant=variant)
            for a, b in zip(got, want):
                assert torch.equal(a, b), slot
            got_faces = eng.detect_faces(frame)
            assert len(got_faces) == len(want_faces)
            for a, b in zip(got_faces, want_faces):
                assert a["bbox"] == b["bbox"] and a["confidence"] == b["confidence"]
                assert np.array_equal(a["landmarks"], b["landmarks"])
            found += int(want.mask.sum())
    assert found > 0
    blaze = isinstance(eng._detector_net, BlazeFace)
    assert len(eng.graphs) == (2 if blaze else 1)  # one capture a key
    # a replay hands out copies: the next replay leaves them as they were
    first = eng.detect(_frames(8, 1)[0])
    kept = [t.clone() for t in first]
    eng.detect(np.zeros((240, 320, 3), np.uint8))
    assert all(torch.equal(a, b) for a, b in zip(first, kept))


@pytest.mark.parametrize("encoder", ["module", "executor"])
@pytest.mark.parametrize("kind", ["boxes", "landmarks", "faces"])
def test_encode_replay_equals_eager_at_every_bucket(cuda_device, kind, encoder):
    eng = _engine("yunet", encoder)
    frame = _frames(9, 1)[0]
    rng = np.random.default_rng(3)
    for k in (1, 2, 3, 5, 9, 16, 17):
        if kind == "boxes":
            rows = np.concatenate([rng.uniform(-5, 200, (k, 2)), rng.uniform(30, 110, (k, 2))], 1)
        elif kind == "landmarks":
            tri = np.array([[0, 0], [35, 2], [17, 25]])[None]
            rows = rng.uniform(20, 200, (k, 1, 2)) + tri * rng.uniform(0.7, 1.3, (k, 1, 1))
        else:
            rows = rng.uniform(0, 1, (k, 160, 160, 3))
        rows = rows.astype(np.float32)
        call = ((lambda: eng.encode_faces(rows)) if kind == "faces"
                else (lambda: getattr(eng, f"encode_{kind}")(frame, rows)))
        with _eager(eng):
            want = call()
        got = call()
        assert got.shape == (k, 128) and np.isfinite(got).all()
        assert np.array_equal(got, want), (kind, encoder, k)
        assert np.array_equal(call(), want)  # a replay of a captured key
    # buckets 1, 2, 4, 8 and 16; encode_faces takes 17 whole (max(max_encode, k))
    assert len(eng.graphs) == (6 if kind == "faces" else 5)


def test_caller_frames_on_the_card_stay_unchanged(cuda_device):
    """Frames handed in on the card are copied into the engine's static
    frame input, never bound by a graph: a later call on another frame
    leaves the first as it was, and each result equals the eager call's."""
    eng = _engine("yunet")
    host = _frames(13, 2)
    video = torch.from_numpy(np.stack(host)).to(cuda_device)
    kept = video.clone()
    rows = np.array([[40, 30, 90, 100], [150, 60, 70, 80]], np.float32)
    lms = np.array([[[60, 70], [95, 72], [77, 95]]], np.float32)
    for i in (0, 1, 0, 1):
        frame = video[i]
        with _eager(eng):
            want = (eng.detect(host[i]), eng.encode_boxes(host[i], rows),
                    eng.encode_landmarks(host[i], lms))
        got = (eng.detect(frame), eng.encode_boxes(frame, rows), eng.encode_landmarks(frame, lms))
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0])), i
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2]), i
        assert torch.equal(video, kept), i
    assert all(t.data_ptr() != video.data_ptr() for t in eng._frames.values())


def _script(seed: int, n: int = 64):
    """Faces on crossing paths, births and deaths, 15% dropouts, a frame
    without detections every seventh."""
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n):
        boxes = [[500 - 5 * f, 80 + 3 * f, 70, 75]]
        if f < 40:
            boxes.append([50 + 4 * f, 60 + 2 * f, 80, 90])
        if f >= 12:
            boxes.append([300, 420 - 3 * (f - 12), 60, 64])
        dets = [{"bbox": [v + int(rng.integers(-2, 3)) for v in b]} for b in boxes
                if rng.random() >= 0.15]
        out.append([] if f % 7 == 6 else dets)
    return out


@pytest.mark.parametrize("assignment", ["hungarian", "greedy", "hungarian_host"])
def test_sort_replay_equals_eager(cuda_device, assignment):
    cfg = TrackerConfig(assignment=assignment)
    graphed, eager = Sort(cfg, device="cuda"), Sort(cfg, device="cuda")
    eager._graphed = lambda device: False
    tables = [t.data_ptr() for t in graphed.table]
    confirmed = 0
    for rnd in range(2):
        for f, dets in enumerate(_script(11 + rnd)):
            before = k2.launches
            got = graphed.update(dets)
            launched = k2.launches - before
            assert got == eager.update(dets), (rnd, f)
            for a, b in zip(graphed.table, eager.table):
                assert torch.equal(a, b), (rnd, f)
            # K2: one a replay (none under hungarian_host); warm-up and capture count nothing
            assert launched == (0 if assignment == "hungarian_host" else 1)
            confirmed += len(got)
        graphed.reset()
        eager.reset()
    assert confirmed > 0
    assert [t.data_ptr() for t in graphed.table] == tables
    assert len(graphed.graphs) == (2 if assignment == "hungarian_host" else 1)


def test_a_failed_capture_raises(cuda_device, monkeypatch):
    def refuse(self, fn, pool):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs.CapturedCall, "_capture", refuse)
    eng = _engine("yunet")
    runs = []
    eng.detector.register_forward_hook(lambda *args: runs.append(1))
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.detect_faces(_frames(12, 1)[0])
    assert len(runs) == 1 and len(eng.graphs) == 0  # the warm-up only: no eager fallback
    tracker = Sort(TrackerConfig(), device="cuda")
    before = k2.launches
    with pytest.raises(RuntimeError, match="capture refused"):
        tracker.update([{"bbox": [10, 10, 40, 40]}])
    assert k2.launches == before and not bool(tracker.table.active.any())
