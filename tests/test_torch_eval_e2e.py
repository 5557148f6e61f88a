"""``fire_tpu_torch.eval_e2e`` and ``train.scenes.render_scene_video``
against the JAX package's.

* The GT video: the port renders the same frames and GT without OpenCV
  (``scene_video``), bitwise; written to XVID through OpenCV, they decode
  to exactly the frames of JAX's file.
* ``score_video``'s scoring, with stub recognizers that emit scripted
  faces (as ``tests/test_eval_e2e.py``), gives equal metrics from the
  video file and from the in-RAM frames.
* One small real engine pair (trained YuNet at 320², a tiny FaceNet with
  shared random weights, float32) on the per-frame and the batched
  path: the same tp / fp / fn, detection recall and precision, identity
  consistency and separation, to 1e-9 (the same counts).
"""

import json
import os

import cv2
import numpy as np
import pytest

from fire_tpu import eval_e2e as JE2E
from fire_tpu.pipeline.recognizer import FaceRecognition as JFR
from fire_tpu.train import scenes as JScenes
from fire_tpu_torch import eval_e2e as TE2E
from fire_tpu_torch.pipeline.recognizer import FaceRecognition
from fire_tpu_torch.train import scenes as TScenes
from tests.test_torch_frame_path import FR_KW, _engines


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _decode(path):
    cap, out = cv2.VideoCapture(path), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


@pytest.mark.parametrize("face_px,hw", [(40, (120, 160)), (200, (300, 420))])
def test_render_scene_video_equal_to_jax(tmp_path, face_px, hw):
    """``face_px`` ≤ 160 renders the patch at its size; above, it is
    area-resized from 160."""
    kw = dict(hw=hw, n_frames=7, face_px=face_px, seed=2)
    jgt = JScenes.render_scene_video(str(tmp_path / "j.avi"),
                                     JScenes.make_identities(3, seed=7), **kw)
    tgt = TScenes.render_scene_video(str(tmp_path / "t.avi"),
                                     TScenes.make_identities(3, seed=7), **kw)
    frames = list(TScenes.scene_video(TScenes.make_identities(3, seed=7), **kw))
    assert len(jgt) == len(tgt) == len(frames) == 7
    for (jb, ji), (tb, ti), (_, fb, fi) in zip(jgt, tgt, frames):
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(fb, jb)
        assert ti == fi == ji
    jdec, tdec = _decode(str(tmp_path / "j.avi")), _decode(str(tmp_path / "t.avi"))
    assert len(jdec) == len(tdec) == 7
    for a, b in zip(jdec, tdec):
        np.testing.assert_array_equal(b, a)
    labels = ["ann", "bob", "cy"]
    lg = TScenes.render_scene_video(str(tmp_path / "l.avi"), TScenes.make_identities(3, seed=7),
                                    labels=labels, **kw)
    assert lg[0][1] == labels


@pytest.fixture(scope="module")
def video_and_gt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    path = str(tmp / "gt.avi")
    gt = TScenes.render_scene_video(path, TScenes.make_identities(2, seed=3), hw=(120, 160),
                                    n_frames=8, face_px=40, seed=1)
    frames = [f for f, _, _ in TScenes.scene_video(TScenes.make_identities(2, seed=3),
                                                   hw=(120, 160), n_frames=8, face_px=40, seed=1)]
    return path, frames, gt


class StubFR:
    """Emits scripted per-frame results from the GT, as the JAX test's."""

    def __init__(self, gt, labeler, drop_second=False):
        self.gt, self.labeler, self.drop_second, self.f = gt, labeler, drop_second, 0

    def recognize_faces(self, frame):
        boxes, ids = self.gt[self.f]
        out = [{"label": self.labeler(gid, self.f), "confidence": 1.0,
                "bbox": [float(v) for v in b]} for b, gid in zip(boxes, ids)]
        if self.drop_second:
            out = out[:1] + [{"label": "ghost", "confidence": 1.0, "bbox": [0.0, 0.0, 10.0, 10.0]}]
        self.f += 1
        return out


LABELERS = {
    "perfect": (lambda gid, f: f"L{gid}", False),
    "flapping": (lambda gid, f: f"L{gid}_{f % 2}" if gid == 0 else "Lx", False),
    "merged": (lambda gid, f: "same", False),
    "missed_and_spurious": (lambda gid, f: f"L{gid}", True),
}


@pytest.mark.parametrize("case", sorted(LABELERS))
@pytest.mark.parametrize("iou", [0.5, 0.9])
def test_score_video_equal_to_jax_with_stub_recognizers(video_and_gt, case, iou):
    path, frames, gt = video_and_gt
    labeler, drop = LABELERS[case]
    ref = JE2E.score_video(StubFR(gt, labeler, drop), path, gt, iou_thresh=iou)
    assert TE2E.score_video(StubFR(gt, labeler, drop), path, gt, iou_thresh=iou) == ref
    assert TE2E.score_video(StubFR(gt, labeler, drop), frames, gt, iou_thresh=iou) == ref
    if case == "perfect" and iou == 0.5:
        assert ref["det_recall"] == ref["det_precision"] == ref["id_consistency"] == 1.0


@pytest.fixture(scope="module")
def real_video(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e_real")
    path = str(tmp / "gt.avi")
    kw = dict(hw=(240, 320), n_frames=12, face_px=100, seed=4)
    gt = TScenes.render_scene_video(path, TScenes.make_identities(2, seed=54), **kw)
    return path, gt


@pytest.mark.parametrize("batch_size", [0, 8], ids=["per-frame", "batched"])
def test_score_video_real_engines_match_jax(tmp_path, real_video, batch_size):
    path, gt = real_video
    jeng, teng = _engines()
    kw = {**FR_KW, "detection_interval": 1}
    jfr = JFR(**kw, storage_root=str(tmp_path / "jax"), engine=jeng, weights_dir=None)
    tfr = FaceRecognition(**kw, storage_root=str(tmp_path / "torch"), engine=teng)
    ref = JE2E.score_video(jfr, path, gt, batch_size=batch_size)
    got = TE2E.score_video(tfr, path, gt, batch_size=batch_size)
    jfr.close(), tfr.close()
    assert got["frames"] == ref["frames"] == 12
    assert (got["tp"], got["fp"], got["fn"]) == (ref["tp"], ref["fp"], ref["fn"])
    assert got["tp"] > 0
    for k in ("det_recall", "det_precision", "id_consistency", "id_separation"):
        assert got[k] == pytest.approx(ref[k], abs=1e-9), k
    assert (got["identities"], got["distinct_labels"]) == (ref["identities"],
                                                           ref["distinct_labels"])


def test_main_prints_one_json_line(tmp_path, capsys, monkeypatch):
    """``python -m fire_tpu_torch.eval_e2e`` at a tiny size on the CPU:
    the committed YuNet, the random-init FaceNet-128."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    wt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "weights_trained", "yunet_synth.msgpack")
    TE2E.main(["--frames", "4", "--width", "320", "--height", "240", "--identities", "2",
               "--face_px", "80", "--encoder", "128", "--trained_detector", wt,
               "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 4 and set(rec) >= {"det_recall", "det_precision", "id_consistency",
                                               "id_separation", "tp", "fp", "fn"}
    assert os.listdir(tmp_path)  # the video and the storage went to the temp folder


def test_render_video_without_cv2_scores_the_frames(tmp_path, monkeypatch):
    from fire_tpu_torch.utils import imageio

    monkeypatch.setattr(imageio, "has_cv2", lambda: False)
    video, gt = TE2E.render_video(str(tmp_path), "gt.avi", TScenes.make_identities(2, seed=3),
                                  (120, 160), 5, 40, 1)
    assert isinstance(video, list) and len(video) == len(gt) == 5
    assert not os.listdir(tmp_path)
    ref = list(TScenes.scene_video(TScenes.make_identities(2, seed=3), hw=(120, 160),
                                   n_frames=5, face_px=40, seed=1))
    for f, (frame, boxes, ids) in enumerate(ref):
        np.testing.assert_array_equal(video[f], frame)
        np.testing.assert_array_equal(gt[f][0], boxes)
