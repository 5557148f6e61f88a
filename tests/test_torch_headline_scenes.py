"""The headline's eight scenes (``bench.py:201-222``: 1080p, one face of
180–360 px each, drawn after the 99,900 gallery rows from one
``default_rng(0)``) through both packages' ``DeviceEngine.detect_faces``
with the committed YuNet at the headline's 640² letterbox, float32 on
the CPU.

Both find the face in the same seven scenes, boxes within 1 px, and
both miss the same one: the scene with the smallest face, so the miss
is the trained detector's, not the port's."""

import copy
import os

import jax.numpy as jnp
import numpy as np

from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu.train import scenes as js
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.train import scenes as ts
from tests.torch_threads import one_torch_thread  # noqa: F401

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")
EKW = dict(detect_size=(640, 640), compute_dtype="float32", strict_f32_preprocess=True)


def _draws():
    """Each package's eight scenes from ``bench.py``'s generator, after
    its gallery rows (drawn in chunks: the same stream, less memory)."""
    rng = np.random.default_rng(0)
    for _ in range(9):
        rng.standard_normal((11_100, 512))
    jrng, trng = rng, copy.deepcopy(rng)
    kw = dict(hw=(1080, 1920), n_faces=(1, 1), face_px=(180, 360))
    jidents, tidents = js.make_identities(8, seed=0), ts.make_identities(8, seed=0)
    return ([js.compose_scene(jrng, jidents, **kw) for _ in range(8)],
            [ts.compose_scene(trng, tidents, **kw) for _ in range(8)])


def test_both_packages_miss_the_same_headline_scene():
    jdrawn, tdrawn = _draws()
    jeng = JEngine(JR(detector_type="yunet", weights_dir=None, engine=JE(**EKW)).with_embedding_dim(),
                   detector=JYuNet(dtype=jnp.float32), encoder=j_tiny(128, dtype=jnp.float32))
    jeng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    teng = DeviceEngine(RecognizerConfig(detector_type="yunet",
                                         engine=EngineConfig(**EKW)).with_embedding_dim(),
                        device="cpu", encoder=tiny_facenet(128))
    teng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    missed = []
    for i, ((jimg, jtrue, _), (timg, ttrue, _)) in enumerate(zip(jdrawn, tdrawn)):
        np.testing.assert_allclose(ttrue, jtrue, atol=1e-4)
        jd = jeng.detect_faces(jimg.astype(np.uint8))
        td = teng.detect_faces(timg.astype(np.uint8))
        assert len(jd) == len(td) <= 1, i
        if jd:
            assert np.abs(np.subtract(jd[0]["bbox"], td[0]["bbox"])).max() <= 1, i
        else:
            missed.append(i)
    sizes = [float(t[1][0, 2]) for t in tdrawn]
    assert missed == [int(np.argmin(sizes))], (missed, sizes)
