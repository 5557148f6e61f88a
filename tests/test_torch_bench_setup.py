"""The headline's workload (``fire_tpu_torch.bench.common``) against
``bench.py:175-224``'s draws made through the JAX package, at a cut-down
size: 1,000 gallery rows and 8 scenes at 216×384 with faces of 36–72 px.

The rows come from the same ``default_rng(0)`` in the same order, so
they are bitwise equal; the scenes that follow get the same draws, so
their boxes and landmarks agree to 1e-4 and their pixels within one
level (the port renders without OpenCV), as
``test_torch_models.py::test_scene_renderer_matches_jax`` holds them."""

import numpy as np

from fire_tpu.train import scenes as js
from fire_tpu_torch.bench import common
from fire_tpu_torch.config import EngineConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

ROWS, SCENES, HW, FACE_PX = 1_000, 8, (216, 384), (36, 72)


def _bench_py_draws():
    """``bench.py:201-222`` at the cut-down size."""
    rng = np.random.default_rng(0)
    gal = rng.standard_normal((ROWS, 512)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    idents = js.make_identities(8, seed=0)
    drawn = [js.compose_scene(rng, idents, hw=HW, n_faces=(1, 1), face_px=FACE_PX)
             for _ in range(SCENES)]
    return gal, drawn


def test_headline_draws_match_bench_py():
    jgal, jdrawn = _bench_py_draws()
    gal, drawn = common.headline_draws(ROWS, 512, SCENES, HW, FACE_PX)
    assert gal.dtype == np.float32 and gal.tobytes() == jgal.tobytes()
    assert len(drawn) == SCENES
    for (ji, jb, jl), (ti, tb, tl) in zip(jdrawn, drawn):
        assert np.abs(ji.astype(np.uint8).astype(int) - ti.astype(np.uint8).astype(int)).max() <= 1
        assert jb.shape == tb.shape == (1, 4)
        np.testing.assert_allclose(tb, jb, atol=1e-4)
        np.testing.assert_allclose(tl, jl, atol=1e-4)


def test_setup_headline_builds_the_bench_py_recognizer(tmp_path):
    """The recognizer of ``bench.py:176-209`` on the CPU: the committed
    weights, the gallery rows in order with a compacted snapshot, and
    the frames of the draws."""
    jgal, jdrawn = _bench_py_draws()
    fr, frames = common.setup_headline(
        str(tmp_path), "cpu", rows=ROWS, scenes=SCENES, hw=HW, face_px=FACE_PX,
        engine_cfg=EngineConfig(detect_size=(160, 160), compute_dtype="float32"))
    try:
        cfg = fr.cfg
        assert (cfg.detector_type, cfg.encoder_model_type) == ("yunet", "512")
        assert (cfg.similarity_threshold, cfg.unknown_trigger_count, fr.detection_interval) == (
            0.7, 1, 1)
        assert fr.tracker_cfg.assignment == "hungarian"
        assert fr.engine.weight_source["detector"].endswith("yunet_synth.msgpack")
        assert fr.engine.weight_source["encoder"].endswith("facenet512_synth.msgpack")
        assert fr.gallery.count == ROWS and fr.gallery.labels[:2] == ["person_0", "person_1"]
        # load_rows normalises each row once more: float32 rounding apart
        np.testing.assert_allclose(fr.gallery._gal[:ROWS].numpy(), jgal, rtol=0, atol=1e-7)
        assert fr.gallery.index_path and (tmp_path / "yunet_512_unencrypted").is_dir()
        assert len(frames) == SCENES and all(f.dtype == np.uint8 and f.shape == (*HW, 3)
                                             for f in frames)
        for f, (ji, _, _) in zip(frames, jdrawn):
            assert np.abs(f.astype(int) - ji.astype(int)).max() <= 1
    finally:
        fr.close()

