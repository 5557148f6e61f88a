"""``fire_tpu_torch.bench.crowd`` (the port of ``tools/bench_crowd.py``)
against the JAX package: its scenes for 1 and 4 faces a frame at a small
size match ``bench_crowd.py:80-88``'s draws through
``fire_tpu.train.scenes`` (pixels within one level, boxes and landmarks
to 1e-4, as ``test_scene_renderer_matches_jax`` holds the renderer), its
bucket ladder equals JAX's ``_bucket_ladder(B*128, None)``, and the late
``max_faces`` change of ``bench_crowd.py:63`` reaches the detector's
output shape in the port's step as in JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fire_tpu.pipeline.batch_engine as JBE
from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu.train import scenes as js
from fire_tpu_torch.bench import crowd
from fire_tpu_torch.config import EngineConfig
from fire_tpu_torch.pipeline import batch_engine as TBE
from tests.torch_threads import one_torch_thread  # noqa: F401

HW = (120, 160)


@pytest.mark.parametrize("n", [1, 4])
def test_crowd_scenes_match_jax(n):
    rng = np.random.default_rng(0)
    got = crowd.crowd_scenes(rng, crowd_identities(), n, HW)
    jrng = np.random.default_rng(0)
    fpx = max(28, min(140, int(np.sqrt(HW[0] * HW[1] / (4 * n)))))
    idents = js.make_identities(32, seed=0)
    want = [js.compose_scene(jrng, idents, hw=HW, n_faces=(n, n), face_px=(fpx, fpx + 20),
                             occlusion_prob=0.0) for _ in range(8)]
    assert len(got) == 8
    for (ti, tb, tl), (ji, jb, jl) in zip(got, want):
        assert np.abs(ti.astype(int) - ji.astype(np.uint8).astype(int)).max() <= 1
        assert tb.shape == jb.shape
        np.testing.assert_allclose(tb, jb, atol=1e-4)
        np.testing.assert_allclose(tl, jl, atol=1e-4)
    # the draws leave both generators in the same state
    assert rng.integers(0, 1 << 30) == jrng.integers(0, 1 << 30)


def crowd_identities():
    from fire_tpu_torch.train.scenes import make_identities

    return make_identities(32, seed=0)


@pytest.mark.parametrize("batch", [8, 32])
def test_bucket_ladder_matches_jax(batch):
    want = list(JBE._bucket_ladder(batch * 128, None))
    assert list(TBE._bucket_ladder(batch * crowd.ENCODE_K, None)) == want
    assert crowd.ENCODE_K == 128 and crowd.MAX_FACES == 128 and crowd.MAX_TRACKS == 192


def test_late_max_faces_reaches_the_detector(tmp_path):
    """``setup_crowd`` raises ``max_faces`` to 128 after the engine is
    built; the port's detector and step see 128 slots a frame, as JAX's
    engine does when the same change precedes its first trace."""
    ecfg = dict(detect_size=(160, 160), encode_size=(96, 96), compute_dtype="float32")
    fr, bse, _ = crowd.setup_crowd(str(tmp_path), "cpu", rows=100, engine_cfg=EngineConfig(**ecfg))
    try:
        assert fr.cfg.engine.max_faces == 128 and fr.engine.cfg is fr.cfg
        frames = torch.zeros((2, *HW, 3), dtype=torch.uint8)
        with torch.inference_mode():
            dets = fr.engine._build_detect(HW)(frames)
            assert dets.mask.shape == (2, 128) and dets.boxes_xywh.shape == (2, 128, 4)
            res = bse.process_batch(frames)
        assert res.tid.shape == (2, 192)
    finally:
        fr.close()

    jcfg = JR(encoder_model_type="128", weights_dir=None,
              engine=JE(detect_size=(160, 160), encode_size=(96, 96))).with_embedding_dim()
    jeng = JEngine(jcfg, detector=JYuNet(dtype=jnp.float32), encoder=j_tiny(128, dtype=jnp.float32))
    object.__setattr__(jcfg.engine, "max_faces", 128)
    jdets = jeng._build_detect(HW)(jeng.det_vars, jnp.zeros((*HW, 3), jnp.uint8))
    assert np.asarray(jdets.mask).shape == (128,)
