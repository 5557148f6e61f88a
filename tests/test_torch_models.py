"""YuNet and FaceNet of the port vs the Flax models on the same weights.

* Random weights, float32: the heads / embeddings agree to 1e-4.
* Trained YuNet through the production detect path (letterbox → CNN →
  decode → NMS) on a rendered scene: equal keep masks, boxes within
  ±1 px, scores to 2e-2.
* Trained FaceNet-512 on two face crops: cosine ≥ 0.99999 in float32
  and ≥ 0.999 in bf16 (the two frameworks round bf16 at different
  points of the ~100-layer network).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.models.facenet import FaceNet as JFaceNet
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu_torch import weights as W
from fire_tpu_torch.models.facenet import FaceNet, tiny_facenet
from fire_tpu_torch.models.yunet import YuNet

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")


def _perturbed(variables, seed):
    """Random but non-trivial variables: jittered params, positive
    variances, non-zero means."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a)) + rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


def test_tiny_yunet_f32_heads():
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    jm = JYuNet(width=8, dtype=jnp.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    jo = jm.apply(v, jnp.asarray(x))
    tm = YuNet(width=8).eval()
    W.load_into(tm, W.from_flax_yunet(v))
    with torch.no_grad():
        to = tm(torch.from_numpy(x))
    assert sorted(jo) == sorted(to) == [8, 16, 32]
    for s in (8, 16, 32):
        for a, b in zip(jo[s], to[s]):
            assert tuple(b.shape) == a.shape and b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_tiny_facenet_f32():
    x = np.random.default_rng(2).uniform(0, 1, (3, 160, 160, 3)).astype(np.float32)
    jm = j_tiny(64)
    v = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 3)
    jo = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tiny_facenet(64).eval()
    W.load_into(tm, W.from_flax_facenet(v))
    with torch.no_grad():
        to = tm(torch.from_numpy(x)).numpy()
    assert to.shape == (3, 64)
    np.testing.assert_allclose(to, jo, atol=1e-4)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_trained_yunet_detect_path(compute):
    from fire_tpu.config import EngineConfig as JE
    from fire_tpu.config import RecognizerConfig as JR
    from fire_tpu.pipeline.engine import DeviceEngine as JEngine
    from fire_tpu_torch.config import EngineConfig, RecognizerConfig
    from fire_tpu_torch.pipeline.engine import DeviceEngine
    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    strict = compute == "float32"
    ekw = dict(detect_size=(320, 320), compute_dtype=compute, strict_f32_preprocess=strict)
    jcfg = JR(weights_dir=None, engine=JE(**ekw)).with_embedding_dim()
    jeng = JEngine(jcfg, detector=JYuNet(dtype=jnp.dtype(compute)),
                   encoder=j_tiny(128, dtype=jnp.float32))
    jeng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    tcfg = RecognizerConfig(engine=EngineConfig(**ekw)).with_embedding_dim()
    teng = DeviceEngine(tcfg, device="cpu", encoder=tiny_facenet(128))
    teng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))

    idents = make_identities(6, seed=9)
    rng = np.random.default_rng(4)
    frames = [compose_scene(rng, idents, hw=(240, 320), n_faces=(1, 2), face_px=(60, 150),
                            occlusion_prob=0.0)[0] for _ in range(3)]
    with torch.no_grad():
        td = teng._build_detect((240, 320))(torch.from_numpy(np.stack(frames)))
    n_found = 0
    for i, f in enumerate(frames):
        jd = jeng.detect(f)
        jm = np.asarray(jd.mask)
        np.testing.assert_array_equal(td.mask[i].numpy(), jm)
        n_found += int(jm.sum())
        np.testing.assert_allclose(td.boxes_xywh[i].numpy()[jm], np.asarray(jd.boxes_xywh)[jm],
                                   atol=1.0)
        np.testing.assert_allclose(td.scores[i].numpy()[jm], np.asarray(jd.scores)[jm], atol=2e-2)
    assert n_found >= 3  # the trained detector finds the rendered faces


@pytest.fixture(scope="module")
def facenet512():
    tree = W.read_msgpack(os.path.join(WT, "facenet512_synth.msgpack"))
    from fire_tpu_torch.train.scenes import make_identities, render_face_patch

    rng = np.random.default_rng(5)
    crops = np.stack([render_face_patch(p, rng)[0] / 255.0 for p in make_identities(2, seed=3)])
    return tree, crops.astype(np.float32)


@pytest.mark.parametrize("compute,min_cos", [("float32", 0.99999), ("bfloat16", 0.999)])
def test_trained_facenet512(facenet512, compute, min_cos):
    tree, crops = facenet512
    jv = {c: jax.tree_util.tree_map(jnp.asarray, tree[c]) for c in ("params", "batch_stats")}
    jo = np.asarray(JFaceNet(embed_dim=512, dtype=jnp.dtype(compute)).apply(jv, jnp.asarray(crops)))
    tm = FaceNet(embed_dim=512).to(getattr(torch, compute)).eval()
    W.load_into(tm, W.from_flax_facenet(tree))
    with torch.no_grad():
        to = tm(torch.from_numpy(crops)).numpy()
    cos = (jo * to).sum(1) / np.linalg.norm(jo, axis=1) / np.linalg.norm(to, axis=1)
    assert cos.min() >= min_cos, cos


def test_scene_renderer_matches_jax():
    """The numpy-only scene renderer (no OpenCV) reproduces the JAX
    package's cv2-based scenes: same draws, pixels within one level."""
    from fire_tpu.train import scenes as js
    from fire_tpu_torch.train import scenes as ts

    assert [sorted(p) for p in js.make_identities(3, 1)] == [sorted(p) for p in ts.make_identities(3, 1)]
    jid, tid = js.make_identities(8, 0), ts.make_identities(8, 0)
    for seed in range(4):
        a = js.compose_scene(np.random.default_rng(seed), jid, hw=(240, 320), n_faces=(1, 2),
                             face_px=(60, 200))
        b = ts.compose_scene(np.random.default_rng(seed), tid, hw=(240, 320), n_faces=(1, 2),
                             face_px=(60, 200))
        assert np.abs(a[0].astype(int) - b[0].astype(int)).max() <= 1
        np.testing.assert_allclose(a[1], b[1], atol=1e-4)
        np.testing.assert_allclose(a[2], b[2], atol=1e-4)
