"""Readback buffers owned by their tokens (``pipeline/batch_engine.py``
``ReadbackPool``): any number of ``submit`` tokens may be outstanding, and
each ``collect`` returns its own batch's results.

On the CPU the pool is driven with a plain allocator, and the engine's
unpacking step with buffers from it.  The ``cuda``-marked tests submit
five distinct batches to ``BatchStreamEngine`` (and five steps to a
two-stream ``MultiStreamEngine``) before collecting any, and compare each
with a second engine run one batch at a time.  This file imports no JAX,
so it runs on the machine with the card too:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_readback_pool.py -q
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fire_tpu_torch.config import RecognizerConfig
from fire_tpu_torch.gallery.index import DeviceGallery
from fire_tpu_torch.models.detections import Detections
from fire_tpu_torch.parallel.mesh import make_mesh
from fire_tpu_torch.parallel.multistream import MultiStreamEngine
from fire_tpu_torch.pipeline.batch_engine import (BatchResults, BatchStreamEngine, Readback,
                                                  ReadbackPool)

DIM, MAXF = 128, 8


def _pool():
    made = []

    def alloc(n):
        made.append(torch.empty(n, dtype=torch.int32))
        return made[-1]

    return ReadbackPool(alloc), made


def test_outstanding_tokens_hold_distinct_buffers():
    pool, made = _pool()
    held = [pool.take(100) for _ in range(5)]
    assert len(made) == 5
    assert len({b.data_ptr() for b in held}) == 5


def test_a_buffer_is_reused_only_after_it_is_given_back():
    pool, made = _pool()
    a, b = pool.take(100), pool.take(100)
    c = pool.take(100)  # nothing given back yet: a new buffer
    assert len(made) == 3 and c is not a and c is not b
    pool.give(b)
    assert pool.take(100) is b
    assert len(made) == 3
    pool.give(a)
    pool.give(c)
    assert {id(pool.take(100)), id(pool.take(100))} == {id(a), id(c)}
    assert len(made) == 3


def test_a_buffer_never_given_back_is_never_handed_out_again():
    pool, made = _pool()
    kept = pool.take(64)
    for _ in range(6):
        buf = pool.take(64)
        assert buf is not kept
        pool.give(buf)
    assert len(made) == 2


@pytest.mark.parametrize("other", [dict(slot=1), dict(n=65)], ids=["other_slot", "other_size"])
def test_buffers_are_kept_by_slot_and_size(other):
    pool, made = _pool()
    buf = pool.take(64, slot=0)
    pool.give(buf, slot=0)
    again = pool.take(other.get("n", 64), slot=other.get("slot", 0))
    assert again is not buf and len(made) == 2


def _fake_engine(device):
    """Row 0 of a frame encodes its boxes ([n, x, y, w, h, ...]); a crop's
    mean intensity m encodes to one-hot(round(m·255/10))."""

    def build_detect(frame_hw, timer=None):
        def run(frames):
            row = frames[:, 0, :, 0].float()
            n = row[:, 0].int()
            idx = torch.arange(MAXF, device=frames.device)
            boxes = torch.stack([row[:, 1 + 4 * idx], row[:, 2 + 4 * idx], row[:, 3 + 4 * idx],
                                 row[:, 4 + 4 * idx]], dim=-1)
            mask = idx[None] < n[:, None]
            lms = torch.zeros((*mask.shape, 5, 2), device=frames.device)
            return Detections(boxes * mask[..., None], lms, torch.where(mask, 0.99, 0.0), mask)

        return run

    def encode(x):
        m = x.mean(dim=(1, 2, 3))
        idx = torch.clamp(torch.round(m * 255.0 / 10.0).long(), 0, DIM - 1)
        return torch.nn.functional.one_hot(idx, DIM).float()

    return SimpleNamespace(_build_detect=build_detect, encode=encode, device=torch.device(device))


def _frames(batch, b=8):
    """Batch ``batch``: one face of identity 3 + batch on a path of its own."""
    out = np.zeros((b, 64, 64, 3), np.uint8)
    for i in range(b):
        x, y, ident = 4 + 3 * batch + i, 6 + 4 * batch, 3 + batch
        out[i, 0, 0, 0] = 1
        out[i, 0, 1:5, 0] = (x, y, 16, 16)
        out[i, y : y + 16, x : x + 16] = ident * 10
    return out


def _setup(device):
    cfg = RecognizerConfig(similarity_threshold=0.7, unknown_trigger_count=1).with_embedding_dim()
    gallery = DeviceGallery(DIM, capacity=1000, device=device)
    v = np.zeros(DIM, np.float32)
    v[5] = 1.0
    gallery.add(v, "person5", db_id=1)
    return cfg, gallery


def _assert_equal(got: BatchResults, want: BatchResults):
    for name in BatchResults._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_unpack_gives_the_buffer_back_after_copying():
    """The unpacking step of ``collect`` on buffers from the engine's pool
    (what ``_readback`` hands out on the card): each token unpacks its own
    batch, and its buffer is free again only after that."""
    cfg, gallery = _setup("cpu")
    engine = BatchStreamEngine(_fake_engine("cpu"), gallery, cfg, encode_k=MAXF)
    pool, made = _pool()
    engine.readback_pool = pool
    packed = []
    for batch in range(5):
        engine.state, p = engine.step(engine.engine, gallery.gal_matmul, gallery.count,
                                      engine.state, torch.from_numpy(_frames(batch)))
        packed.append(p)
    reads = []
    for p in packed:
        host = pool.take(p.numel())
        host.copy_(p)
        reads.append(Readback(host, None, 0))
    assert len({r.host.data_ptr() for r in reads}) == 5
    ref = BatchStreamEngine(_fake_engine("cpu"), gallery, cfg, encode_k=MAXF)
    for batch, read in enumerate(reads):
        _assert_equal(engine._unpack(read, 8), ref.process_batch(_frames(batch)))
        assert pool.take(packed[0].numel()) is read.host  # free again, and only now
        pool.give(read.host)
    assert len(made) == 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the readback goes through pinned memory there only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batch_engine_collects_five_outstanding_batches(cuda_device):
    cfg, gallery = _setup("cuda")
    engine = BatchStreamEngine(_fake_engine("cuda"), gallery, cfg, encode_k=MAXF)
    ref = BatchStreamEngine(_fake_engine("cuda"), gallery, cfg, encode_k=MAXF)
    tokens = [engine.submit(_frames(batch)) for batch in range(5)]
    assert len({t[0].host.data_ptr() for t in tokens}) == 5
    got = [engine.collect(t) for t in tokens]
    for batch, res in enumerate(got):
        _assert_equal(res, ref.process_batch(_frames(batch)))


@pytest.mark.cuda
def test_multistream_engine_collects_five_outstanding_steps(cuda_device):
    cfg, gallery = _setup("cuda")
    mesh = make_mesh(devices=["cuda:0"] * 2)
    engine = MultiStreamEngine(_fake_engine("cuda"), gallery, cfg, mesh, encode_k=MAXF)
    ref = MultiStreamEngine(_fake_engine("cuda"), gallery, cfg, mesh, encode_k=MAXF)
    steps = [np.stack([_frames(step), _frames(step + 5)]) for step in range(5)]
    tokens = [engine.submit(x) for x in steps]
    got = [engine.collect(t) for t in tokens]
    for x, res in zip(steps, got):
        for stream, want in enumerate(ref.process_batches(x)):
            _assert_equal(res[stream], want)
