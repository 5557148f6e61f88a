"""The port's ``MultiStreamEngine`` against ``fire_tpu``'s on the same
frames: JAX on its eight CPU devices, the port on a mesh of ``"cpu"``
entries.  With the fake engine of ``tests/test_batch_engine.py`` (and its
torch twin here) every field of every stream's results is equal; with
the trained YuNet and a tiny FaceNet sharing random weights, ids are
exact, boxes within ±1 px and similarities within 1e-3, as the batched
step's own parity test holds them."""

from types import SimpleNamespace

import jax
import numpy as np
import torch

from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.config import TrackerConfig as JT
from fire_tpu.gallery.index import DeviceGallery as JGallery
from fire_tpu.parallel.mesh import make_mesh as j_make_mesh
from fire_tpu.parallel.multistream import MultiStreamEngine as JMSE
from fire_tpu_torch.config import RecognizerConfig, TrackerConfig
from fire_tpu_torch.gallery.index import DeviceGallery
from fire_tpu_torch.models.detections import Detections
from fire_tpu_torch.parallel.mesh import make_mesh
from fire_tpu_torch.parallel.multistream import MultiStreamEngine
from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine
from tests.test_batch_engine import DIM, MAXF, _fake_engine, _frame
from tests.test_torch_batch_engine import _compare, _galleries, engines  # noqa: F401

FIELDS = ("tid", "boxes", "gid", "sim", "mask", "enroll", "enroll_emb", "enroll_frame",
          "enroll_slot")


def fake_engine(device="cpu"):
    """The torch twin of ``tests/test_batch_engine._fake_engine``: row 0
    of a frame encodes its boxes, and a crop's mean intensity m encodes
    to one-hot(round(m·255/10))."""

    def build_detect(frame_hw, timer=None):
        def run(frames):
            row = frames[:, 0, :, 0].float()
            n = row[:, 0].int()
            idx = torch.arange(MAXF, device=frames.device)
            boxes = torch.stack([row[:, 1 + 4 * idx], row[:, 2 + 4 * idx], row[:, 3 + 4 * idx],
                                 row[:, 4 + 4 * idx]], dim=-1)
            mask = idx[None] < n[:, None]
            lms = torch.zeros((*mask.shape, 5, 2), device=frames.device)
            scores = torch.where(mask, 0.99, 0.0)
            return Detections(boxes * mask[..., None], lms, scores, mask)

        return run

    def encode(x):
        m = x.mean(dim=(1, 2, 3))
        idx = torch.clamp(torch.round(m * 255.0 / 10.0).long(), 0, DIM - 1)
        return torch.nn.functional.one_hot(idx, DIM).float()

    return SimpleNamespace(_build_detect=build_detect, encode=encode, device=torch.device(device))


def _cfgs():
    jcfg = JR(similarity_threshold=0.7, unknown_trigger_count=1).with_embedding_dim()
    tcfg = RecognizerConfig(similarity_threshold=0.7, unknown_trigger_count=1).with_embedding_dim()
    return jcfg, tcfg


def _gallery_pair(capacity=1000, idents=(3, 7)):
    jg, tg = JGallery(DIM, capacity=capacity), DeviceGallery(DIM, capacity=capacity, device="cpu")
    for i, ident in enumerate(idents):
        v = np.zeros(DIM, np.float32)
        v[ident] = 1.0
        jg.add(v, f"person{ident}", db_id=i + 1)
        tg.add(v, f"person{ident}", db_id=i + 1)
    return jg, tg


def _stream_frames(s, step=0, b=8):
    ident = [3, 7, 5, 9][s % 4]
    return np.stack([_frame([((8 + 2 * s + i + b * step, 10 + s, 16, 16), ident)])
                     for i in range(b)])


def _equal(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def test_multistream_equals_jax_and_keeps_state():
    """8 streams over 8 devices, two steps: every stream's packed results
    equal JAX's, and tracks confirmed in the first step keep their ids."""
    jcfg, tcfg = _cfgs()
    jg, tg = _gallery_pair()
    jms = JMSE(_fake_engine(), jg, jcfg, j_make_mesh((8, 1)), JT(), encode_k=MAXF)
    tms = MultiStreamEngine(fake_engine(), tg, tcfg, make_mesh(devices=["cpu"] * 8),
                            TrackerConfig(), encode_k=MAXF)
    assert tms.n_streams == 8 and len(tms.states) == 8
    out = []
    for step in range(2):
        frames = np.stack([_stream_frames(s, step) for s in range(8)])
        jr, tr = jms.process_batches(frames), tms.process_batches(frames)
        assert len(tr) == 8
        for t, j in zip(tr, jr):
            _equal(t, j)
        out.append(tr)
    for s in range(8):
        t1 = set(out[0][s].tid[out[0][s].mask].tolist())
        t2 = set(out[1][s].tid[out[1][s].mask].tolist())
        assert t1 and t1 <= t2
    # streams of identities 3 and 7 matched the gallery; the others enrol
    for s in (0, 1, 4, 5):
        assert (out[0][s].gid[out[0][s].mask] >= 0).all()
    for s in (2, 3, 6, 7):
        assert (out[0][s].enroll_frame >= 0).any()


def test_multistream_equals_single_stream_engines():
    """Each stream equals a single-stream engine of its own on the same
    frames and gallery."""
    _, tcfg = _cfgs()
    _, tg = _gallery_pair()
    tms = MultiStreamEngine(fake_engine(), tg, tcfg, make_mesh(devices=["cpu"] * 4),
                            encode_k=MAXF)
    singles = [BatchStreamEngine(fake_engine(), tg, tcfg, encode_k=MAXF) for _ in range(4)]
    for step in range(2):
        frames = np.stack([_stream_frames(s, step) for s in range(4)])
        for s, got in enumerate(tms.process_batches(frames)):
            _equal(got, singles[s].process_batch(frames[s]))


def test_inactive_streams_get_the_cached_zero_batch():
    """Inactive streams run on a cached zero batch: what their slot of
    the frames holds is never read (here it is all 255, which would
    decode as 255 boxes), in either package."""
    jcfg, tcfg = _cfgs()
    jg, tg = _gallery_pair()
    jms = JMSE(_fake_engine(), jg, jcfg, j_make_mesh((8, 1)), JT(), encode_k=MAXF)
    tms = MultiStreamEngine(fake_engine(), tg, tcfg, make_mesh(devices=["cpu"] * 8),
                            TrackerConfig(), encode_k=MAXF)
    active = [True, True, False, True, False, False, True, True]
    for step in range(2):
        frames = np.stack([_stream_frames(s, step) if active[s]
                           else np.full((8, 64, 64, 3), 255, np.uint8) for s in range(8)])
        jr = jms.collect(jms.submit(frames, active=active))
        tr = tms.collect(tms.submit(frames, active=active))
        for s, (t, j) in enumerate(zip(tr, jr)):
            _equal(t, j)
            assert t.mask.any() == active[s]
    assert sorted(tms._zero_batches) == [(64, 64, 8, i) for i in (2, 4, 5)]
    z = tms._zero_batches[(64, 64, 8, 2)]
    assert z.shape == (8, 64, 64, 3) and not z.any()


def test_replicas_on_a_second_device():
    """A mesh of two distinct devices gets an engine and a gallery
    replica for the second; the replica takes only the rows added since
    its last sync, and the results equal a one-device mesh's."""
    _, tcfg = _cfgs()
    _, tg1 = _gallery_pair()
    _, tg2 = _gallery_pair()
    one = MultiStreamEngine(fake_engine(), tg1, tcfg, make_mesh(devices=["cpu"] * 2),
                            encode_k=MAXF)
    two = MultiStreamEngine(fake_engine(), tg2, tcfg, make_mesh(devices=["cpu", "cpu:0"]),
                            encode_k=MAXF)
    assert len(one.engines) == 1 and len(two.engines) == 2
    second = two.engines[torch.device("cpu:0")]
    assert second is not two.inner.engine and second.device == torch.device("cpu:0")
    for step in range(3):
        frames = np.stack([_stream_frames(s, step) for s in range(2)])
        for a, b in zip(one.process_batches(frames), two.process_batches(frames)):
            _equal(b, a)
        v = np.zeros(DIM, np.float32)
        v[20 + step] = 1.0
        for g in (tg1, tg2):
            g.add(v, f"new{step}", 10 + step)
    rep, synced = two._gal_replicas[torch.device("cpu:0")]
    assert synced == tg2.count - 1  # the last row was added after the last step
    assert torch.equal(rep[:synced], tg2.gal_matmul[:synced])


def test_real_models_equal_jax(engines):  # noqa: F811
    """Two streams of rendered scenes through the trained YuNet at 320²
    and a tiny FaceNet with shared weights, two steps, the second after
    the first step's enrolments reached both galleries."""
    jcfg, jeng, tcfg, teng, scenes = engines
    jg, tg = _galleries()
    jms = JMSE(jeng, jg, jcfg, j_make_mesh((2, 1), devices=jax.devices()[:2]))
    tms = MultiStreamEngine(teng, tg, tcfg, make_mesh(devices=["cpu"] * 2))
    a, b = scenes
    frames = np.stack([np.stack([a] * 8), np.stack([b] * 8)])
    j1, t1 = jms.process_batches(frames), tms.process_batches(frames)
    for t, j in zip(t1, j1):
        _compare(t, j)
    for s, j in enumerate(j1):
        for i in np.nonzero(j.enroll_frame >= 0)[0]:
            emb = j.enroll_emb[i] / np.linalg.norm(j.enroll_emb[i])
            jg.add(emb, f"new{s}{i}", 1000 + 10 * s + i)
            tg.add(emb, f"new{s}{i}", 1000 + 10 * s + i)
    frames = np.stack([np.stack([b] * 8), np.stack([a] * 8)])
    j2, t2 = jms.process_batches(frames), tms.process_batches(frames)
    for t, j in zip(t2, j2):
        _compare(t, j)
    assert all(j.mask.any() for j in j2) and any(j.enroll.any() for j in j1)
