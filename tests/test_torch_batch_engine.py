"""The port's batched step vs fire_tpu's BatchStreamEngine on the same
frames and weights: trained YuNet + tiny FaceNet with shared random
weights, float32, B=8, over two batches (the second after the first's
enrollment reached both galleries).

ids, gallery rows, masks, enroll flags and enroll frames are exact;
boxes within ±1 px; sims to 1e-3 (the crops keep bf16 intermediates on
both sides, summed in different orders)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.gallery.index import DeviceGallery as JGallery
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.pipeline.batch_engine import BatchStreamEngine as JBSE
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.gallery.index import DeviceGallery
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.pipeline import batch_engine as TB
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.train.scenes import compose_scene, make_identities

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")
DIM = 128
EKW = dict(detect_size=(320, 320), compute_dtype="float32", strict_f32_preprocess=True)
RKW = dict(similarity_threshold=0.7, unknown_trigger_count=1, weights_dir=None)


@pytest.fixture(scope="module")
def engines():
    jcfg = JR(**RKW, engine=JE(**EKW)).with_embedding_dim()
    jeng = JEngine(jcfg, detector=JYuNet(dtype=jnp.float32), encoder=j_tiny(DIM, dtype=jnp.float32))
    jeng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    tcfg = RecognizerConfig(**RKW, engine=EngineConfig(**EKW)).with_embedding_dim()
    teng = DeviceEngine(tcfg, device="cpu", encoder=tiny_facenet(DIM))
    teng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    teng.load_encoder_variables(jax.tree_util.tree_map(np.asarray, jeng.enc_vars), "shared random")
    idents = make_identities(6, seed=21)
    rng = np.random.default_rng(22)
    scenes = [compose_scene(rng, idents, hw=(240, 320), n_faces=(1, 2), face_px=(70, 150),
                            occlusion_prob=0.0)[0] for _ in range(2)]
    return jcfg, jeng, tcfg, teng, scenes


def _galleries():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((300, DIM)).astype(np.float32)
    rows = [(i + 1, f"p{i}", rows[i].tobytes()) for i in range(300)]
    jg, tg = JGallery(DIM, capacity=1000), DeviceGallery(DIM, capacity=1000, device="cpu")
    jg.load_rows(rows)
    tg.load_rows(rows)
    return jg, tg


def _compare(t, j):
    for f in ("tid", "gid", "mask", "enroll", "enroll_frame", "enroll_slot"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert np.abs(t.boxes.astype(np.int64) - j.boxes).max() <= 1
    np.testing.assert_allclose(t.sim, j.sim, atol=1e-3)
    ok = j.enroll_frame >= 0
    np.testing.assert_allclose(t.enroll_emb[ok], j.enroll_emb[ok], atol=1e-3)


@pytest.mark.parametrize("interval,buckets", [(1, None), (1, ()), (2, None), (2, ())])
def test_batched_step_matches_jax(engines, interval, buckets):
    jcfg, jeng, tcfg, teng, scenes = engines
    jg, tg = _galleries()
    jb = JBSE(jeng, jg, jcfg, detection_interval=interval, encode_buckets=buckets)
    tb = TB.BatchStreamEngine(teng, tg, tcfg, detection_interval=interval, encode_buckets=buckets)
    a, b = scenes
    batch1 = np.stack([a] * 8)
    j1, t1 = jb.process_batch(batch1), tb.process_batch(batch1)
    _compare(t1, j1)
    # the host enrolls the flagged faces into both galleries
    for i in np.nonzero(j1.enroll_frame >= 0)[0]:
        emb = j1.enroll_emb[i] / np.linalg.norm(j1.enroll_emb[i])
        jg.add(emb, f"new{i}", 1000 + i)
        tg.add(emb, f"new{i}", 1000 + i)
    batch2 = np.stack([a] * 4 + [b] * 4)
    j2, t2 = jb.process_batch(batch2), tb.process_batch(batch2)
    _compare(t2, j2)
    # the path was really exercised: tracks confirmed and enrolled
    assert j2.mask.any() and (j1.enroll.any() or j2.enroll.any())
    if interval == 1:  # the batch-1 enrollment is matched in batch 2
        assert (j2.gid[j2.mask] >= 300).any()


def test_pack_roundtrip_and_bucket_ladder():
    from fire_tpu.pipeline.batch_engine import _bucket_ladder as j_ladder

    for nk in (8, 64, 512, 2048):
        for opt in (None, (), (100, 300), (5,)):
            assert TB._bucket_ladder(nk, opt) == j_ladder(nk, opt)
    b, t, d = 2, 3, 4
    rng = np.random.default_rng(0)
    res = (torch.from_numpy(rng.integers(0, 9, (b, t)).astype(np.int32)),
           torch.from_numpy(rng.integers(0, 9, (b, t, 4)).astype(np.int32)),
           torch.full((b, t), -1, dtype=torch.int32), torch.rand(b, t),
           torch.rand(b, t) > 0.5, torch.rand(b, t) > 0.5, torch.rand(TB.MAX_ENROLL, d),
           torch.arange(TB.MAX_ENROLL, dtype=torch.int32), torch.arange(TB.MAX_ENROLL, dtype=torch.int32))
    out = TB.unpack_results(TB.pack_results(res).numpy(), b, t, d)
    for x, y in zip(res, out):
        np.testing.assert_array_equal(x.numpy(), y)
