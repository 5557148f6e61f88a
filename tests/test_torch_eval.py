"""The eval harnesses of the port against the JAX package's:
``train.synth`` (``render_identity`` / ``generate``, bitwise),
``train.detect.detection_pr``, ``eval`` (``pair_scores``, ``roc_auc``,
``identification_auc``, ``encode_directory``, ``evaluate_directory``),
``calibrate`` (``_best_iou_box``, ``sweep``,
``collect_production_embeddings``) and ``eval_detect``.

The scoring functions are compared on the same inputs and must give
equal results.  Through the engines (trained YuNet at 320², a tiny
FaceNet with shared random weights, float32): the same detections
(tp / fp / fn), embeddings to cosine ≥ 0.9999 and AUCs to 1e-3.
"""

import json
import os

import cv2
import numpy as np
import pytest

from fire_tpu import calibrate as JCal
from fire_tpu import eval as JEval
from fire_tpu.train import detect as JDetect
from fire_tpu.train import scenes as JScenes
from fire_tpu.train import synth as JSynth
from fire_tpu_torch import calibrate as TCal
from fire_tpu_torch import eval as TEval
from fire_tpu_torch import eval_detect as TEvalDetect
from fire_tpu_torch.train import detect as TDetect
from fire_tpu_torch.train import scenes as TScenes
from fire_tpu_torch.train import synth as TSynth
from fire_tpu_torch.utils import imageio
from tests.test_torch_frame_path import _engines


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,size", [(0, 160), (5, 48), (11, 97)])
def test_render_identity_bitwise_equal(seed, size):
    pj = JSynth._identity_params(np.random.default_rng(seed))
    pt = TSynth._identity_params(np.random.default_rng(seed))
    aj, at = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    for _ in range(4):  # one generator, several draws: the streams stay in step
        np.testing.assert_array_equal(TSynth.render_identity(pt, at, size),
                                      JSynth.render_identity(pj, aj, size))


def test_generate_writes_the_same_images(tmp_path):
    jt = JSynth.generate(str(tmp_path / "jax"), 3, 2, 1, 48, seed=5)
    tt = TSynth.generate(str(tmp_path / "torch"), 3, 2, 1, 48, seed=5)
    assert [os.path.relpath(p, tmp_path / "torch") for p in tt] == \
        [os.path.relpath(p, tmp_path / "jax") for p in jt]
    files = []
    for root, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.join(root, n) for n in names]
    assert len(files) == 3 * 3
    for jpath in files:
        tpath = jpath.replace(str(tmp_path / "jax"), str(tmp_path / "torch"))
        ref = cv2.imread(jpath)
        np.testing.assert_array_equal(cv2.imread(tpath), ref)      # OpenCV reads the port's PNG
        np.testing.assert_array_equal(imageio.imread(tpath), ref)  # and so does the port
        np.testing.assert_array_equal(imageio.imread(jpath), ref)  # and OpenCV's


def test_synth_main_prints_the_roots(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["synth", "--out", str(tmp_path), "--identities", "2",
                                     "--images", "1", "--holdout", "1", "--size", "32"])
    TSynth.main()
    out = capsys.readouterr().out
    assert f"train: {tmp_path / 'train'}" in out and f"test:  {tmp_path / 'test'}" in out
    assert sorted(os.listdir(tmp_path / "test")) == ["id0000", "id0001"]


def _scripted_detector(scenes, seed):
    """Detections derived from GT: jittered, some dropped, some spurious,
    with landmarks on some."""
    rng = np.random.default_rng(seed)
    by_id = {id(s[0]): s for s in scenes}

    def detect(img):
        _, boxes, lms = by_id[id(img)]
        out = []
        for b, lm in zip(boxes, lms):
            if rng.random() < 0.2:
                continue
            d = {"bbox": (np.asarray(b) + rng.normal(0, 4, 4)).tolist()}
            if rng.random() < 0.5:
                d["landmarks"] = (lm + rng.normal(0, 2, lm.shape)).astype(np.float32)
            out.append(d)
        if rng.random() < 0.3:
            out.append({"bbox": rng.uniform(0, 100, 4).tolist()})
        return out

    return detect


def test_detection_pr_equal_to_jax():
    idents = TScenes.make_identities(5, seed=3)
    rng = np.random.default_rng(4)
    scenes = [TScenes.compose_scene(rng, idents, hw=(120, 160), n_faces=(0, 3), face_px=(20, 60))
              for _ in range(12)]
    for thr in (0.3, 0.5, 0.7):
        got = TDetect.detection_pr(_scripted_detector(scenes, 9), scenes, iou_thresh=thr)
        ref = JDetect.detection_pr(_scripted_detector(scenes, 9), scenes, iou_thresh=thr)
        assert got == ref
    a, b = [10.0, 10.0, 20.0, 30.0], [15.0, 5.0, 20.0, 20.0]
    assert TDetect._iou(a, b) == JDetect._iou(a, b)
    assert TDetect._iou(a, [0, 0, 0, 0]) == JDetect._iou(a, [0, 0, 0, 0]) == 0.0


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_pair_scores_and_auc_equal_to_jax(metric):
    rng = np.random.default_rng(1)
    embs = rng.standard_normal((24, 16)).astype(np.float32)
    embs[5] = embs[3]  # an exact tie
    labels = [i // 4 for i in range(24)]
    s, y = TEval.pair_scores(embs, labels, metric)
    js, jy = JEval.pair_scores(embs, labels, metric)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(y, jy)
    assert TEval.roc_auc(s, y) == JEval.roc_auc(js, jy)
    assert TEval.identification_auc(embs, labels) == JEval.identification_auc(embs, labels)
    ties = np.round(s, 1)  # many ties
    assert TEval.roc_auc(ties, y) == JEval.roc_auc(ties, jy)
    with pytest.raises(ValueError, match="unknown metric"):
        TEval.pair_scores(embs, labels, "manhattan")
    with pytest.raises(ValueError, match="positive and negative"):
        TEval.roc_auc(s, np.ones_like(y))


def test_sweep_and_best_iou_box_equal_to_jax():
    rng = np.random.default_rng(2)
    for gen_mu in (0.9, 0.6):  # separable, then overlapping
        gen = rng.normal(gen_mu, 0.05, 200)
        imp = rng.normal(0.4, 0.1, 900)
        scores = np.concatenate([gen, imp])
        is_same = np.concatenate([np.ones(200, bool), np.zeros(900, bool)])
        assert TCal.sweep(scores, is_same, TCal.CANDIDATES) == \
            JCal.sweep(scores, is_same, TCal.CANDIDATES)
    boxes = rng.uniform(0, 100, (6, 4)).astype(np.float32)
    for gt in (boxes[3] + 1, np.array([500, 500, 10, 10], np.float32), boxes[0]):
        assert TCal._best_iou_box(boxes, gt) == JCal._best_iou_box(boxes, gt)


@pytest.fixture(scope="module")
def identity_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("ids")
    TSynth.generate(str(root), n_identities=3, images_per_id=0, holdout_per_id=3, size=160,
                    seed=2)
    # one more folder of another size and format, and files that are skipped
    extra = root / "test" / "id0099"
    extra.mkdir()
    for k in range(2):
        img = TSynth.render_identity(TSynth._identity_params(np.random.default_rng(99)),
                                     np.random.default_rng(k), 120)
        cv2.imwrite(str(extra / f"x{k}.bmp"), img[..., ::-1])
    (extra / "notes.txt").write_text("not an image")
    return str(root / "test")


def test_encode_directory_matches_jax(identity_folder):
    jeng, teng = _engines()
    te, tl = TEval.encode_directory(teng, identity_folder)
    je, jl = JEval.encode_directory(jeng, identity_folder)
    assert tl == jl and len(tl) == 3 * 3 + 2
    cos = (te * je).sum(1) / np.linalg.norm(te, axis=1) / np.linalg.norm(je, axis=1)
    assert cos.min() >= 0.9999
    got, ref = TEval.identification_auc(te, tl), JEval.identification_auc(je, jl)
    for m in ref:
        assert got[m] == pytest.approx(ref[m], abs=1e-3)
    empty = os.path.join(os.path.dirname(identity_folder), "train")  # folders, no images
    for encode in (TEval.encode_directory, JEval.encode_directory):
        with pytest.raises(ValueError, match="no decodable images"):
            encode(teng if encode is TEval.encode_directory else jeng, empty)


def test_evaluate_directory_matches_jax(tmp_path):
    """detect → align → encode per image, on rendered one-face scenes."""
    jeng, teng = _engines()
    idents = TScenes.make_identities(3, seed=21)
    rng = np.random.default_rng(22)
    for k in range(3):
        d = tmp_path / f"p{k}"
        d.mkdir()
        for v in range(2):
            img, _, _ = TScenes.compose_scene(rng, [idents[k]], hw=(240, 320), n_faces=(1, 1),
                                              face_px=(90, 150), occlusion_prob=0.0)
            imageio.imwrite(str(d / f"v{v}.png"), img)
    got = TEval.evaluate_directory(teng, str(tmp_path))
    ref = JEval.evaluate_directory(jeng, str(tmp_path))
    assert sorted(got) == sorted(ref) == ["cosine", "euclidean"]
    for m in ref:
        assert got[m] == pytest.approx(ref[m], abs=1e-3)


def test_eval_main_prints_one_json_line(identity_folder, capsys):
    TEval.main(["--data", identity_folder, "--encoder", "128", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n"] == 11 and rec["trained"] is False
    assert sorted(rec["auc"]) == ["cosine", "euclidean"]


def test_collect_production_embeddings_and_calibrate_match_jax():
    jeng, teng = _engines()
    kw = dict(n_identities=3, views=2, seed=5, hw=(240, 320), face_px=(90, 150))
    te, tl = TCal.collect_production_embeddings(teng, **kw)
    je, jl = JCal.collect_production_embeddings(jeng, **kw)
    assert tl == jl and len(tl) >= 4
    assert ((te * je).sum(1)).min() >= 0.9999  # both unit-norm
    s, y = TEval.pair_scores(te, tl)
    js, jy = JEval.pair_scores(je, jl)
    got, ref = TCal.sweep(s, y, TCal.CANDIDATES), JCal.sweep(js, jy, TCal.CANDIDATES)
    assert got["n_genuine"] == ref["n_genuine"] and got["n_imposter"] == ref["n_imposter"]
    assert got["genuine"]["p50"] == pytest.approx(ref["genuine"]["p50"], abs=2e-3)
    assert got["imposter"]["p98"] == pytest.approx(ref["imposter"]["p98"], abs=2e-3)


def test_eval_detect_matches_jax():
    """``eval_detect``'s scenes and scoring through both packages'
    engines (JAX's ``main`` inlined: the same scenes and ``detection_pr``)."""
    jeng, teng = _engines()
    args = TEvalDetect.build_parser().parse_args(
        ["--scenes", "6", "--identities", "8", "--scene_hw", "240", "320", "--face_px", "60",
         "130", "--device", "cpu"])
    got = TEvalDetect.evaluate(args, engine=teng)
    idents = JScenes.make_identities(8, seed=0)
    rng = np.random.default_rng(31337)
    scenes = [JScenes.compose_scene(rng, idents, hw=(240, 320), n_faces=(1, 2), face_px=(60, 130))
              for _ in range(6)]
    ref = JDetect.detection_pr(jeng.detect_faces, scenes, iou_thresh=0.5)
    assert (got["tp"], got["fp"], got["fn"]) == (ref["tp"], ref["fp"], ref["fn"])
    assert got["tp"] > 0
    assert got["mean_iou"] == pytest.approx(ref["mean_iou"], abs=1e-2)
    assert got["detector"] == "yunet" and got["weights"].startswith("trained:")


WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")


def test_eval_detect_and_calibrate_mains_print_one_json_line(capsys):
    """Both entry points on the CPU at a tiny size, the committed YuNet
    (``calibrate``'s FaceNet-128 is the random init)."""
    TEvalDetect.main(["--scenes", "2", "--identities", "3", "--scene_hw", "120", "160",
                      "--trained_detector", os.path.join(WT, "yunet_synth.msgpack"),
                      "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["detector"] == "yunet" and rec["weights"].endswith("yunet_synth.msgpack")
    assert {"precision", "recall", "f1", "mean_iou", "tp", "fp", "fn"} <= set(rec)
    TCal.main(["--identities", "2", "--views", "2", "--detect_size", "160", "--encoder", "128",
               "--trained_detector", os.path.join(WT, "yunet_synth.msgpack"), "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["reference_threshold"] == 0.7 and len(rec["sweep"]) == len(TCal.CANDIDATES)
    assert rec["n_genuine"] + rec["n_imposter"] >= 1
