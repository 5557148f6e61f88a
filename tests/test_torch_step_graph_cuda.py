"""The batched step's CUDA graph on the card (``pipeline/batch_engine.py``
``StepGraph``) against its plain version, the eager step, and K1's
device-count form against K1's plain version.

Needs an NVIDIA card and nvcc, and skips without them.  This file
imports no JAX, so it runs on the machine with the card, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_step_graph_cuda.py -q

The engine is the readback tests' stand-in (row 0 of a frame lists its
boxes, a crop encodes to a one-hot of its mean): with B = 8 and 8 slots
a frame the ladder is (8, 32, 64), and frames of 1, 3 and 6 faces reach
its three rungs.  Every field of a replay's results equals the eager
step's on a copy of the same state.
"""

import numpy as np
import pytest
import torch

from fire_tpu_torch.ops import cosine_top1 as k1
from fire_tpu_torch.parallel.mesh import make_mesh
from fire_tpu_torch.parallel.multistream import MultiStreamEngine
from fire_tpu_torch.pipeline import batch_engine as TB
from fire_tpu_torch.track import scan as k2
from test_torch_readback_pool import DIM, MAXF, _assert_equal, _fake_engine, _setup

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the step graph and K1 run there only")
    return torch.device("cuda")


def _crowd(batch: int, faces: int, b: int = 8) -> np.ndarray:
    """``faces`` faces a frame, each of identity 3 + its column."""
    out = np.zeros((b, 64, 160, 3), np.uint8)
    for i in range(b):
        out[i, 0, 0, 0] = faces
        for f in range(faces):
            x, y = 2 + 24 * f + i + batch, 8 + 2 * batch
            out[i, 0, 1 + 4 * f : 5 + 4 * f, 0] = (x, y, 16, 16)
            out[i, y : y + 16, x : x + 16] = (3 + f) * 10
    return out


def _eager(engine: TB.BatchStreamEngine, frames: np.ndarray, state):
    """The plain version on a copy of ``state``: results and the new state."""
    gallery = engine.gallery
    scratch = TB.clone_state(state)
    with torch.inference_mode():
        new, packed = engine.step(engine.engine, gallery.gal_matmul, gallery.count_dev, scratch,
                                  torch.from_numpy(frames).cuda())
    return TB.unpack_results(packed.cpu().numpy(), frames.shape[0], engine.tcfg.max_tracks,
                             engine.cfg.embedding_dim), new


def test_replay_equals_eager_step_at_every_rung_and_after_an_enrolment(cuda_device):
    cfg, gallery = _setup("cuda")
    engine = TB.BatchStreamEngine(_fake_engine("cuda"), gallery, cfg, encode_k=MAXF)
    for step, faces in enumerate((1, 3, 6, 1, 6)):
        frames = _crowd(step, faces)
        if step == 3:  # an enrolment between two replays: matched without a new capture
            v = np.zeros(DIM, np.float32)
            v[3] = 1.0
            gallery.add(v, "person3", db_id=2)
        want, want_state = _eager(engine, frames, engine.state)
        launches = k1.launches, k2.launches  # a capture counts nothing, a replay one each
        got = engine.process_batch(frames)
        assert (k1.launches - launches[0], k2.launches - launches[1]) == (1, 1)
        _assert_equal(got, want)
        for a, b in zip(TB.state_tensors(engine.state), TB.state_tensors(want_state)):
            assert torch.equal(a, b)
    assert len(list(engine.graphs)) == 1
    assert (got.gid[got.mask] == 1).any()  # person3, enrolled after the capture


def test_two_stream_graph_equals_eager_steps(cuda_device):
    cfg, gallery = _setup("cuda")
    mesh = make_mesh(devices=["cuda:0"] * 2)
    engine = MultiStreamEngine(_fake_engine("cuda"), gallery, cfg, mesh, encode_k=MAXF)
    for step, faces in enumerate(((1, 6), (3, 1), (6, 3))):
        frames = np.stack([_crowd(step, f) for f in faces])
        want = [_eager(engine.inner, frames[s], engine.states[s]) for s in range(2)]
        got = engine.process_batches(frames)
        for s in range(2):
            _assert_equal(got[s], want[s][0])
    assert len(list(engine.graphs)) == 1


@pytest.mark.parametrize("count", [0, 1, 2047, 2048, 99_900, 100_352])
def test_k1_device_count_equals_plain(cuda_device, count):
    rng = np.random.default_rng(count)
    g = rng.standard_normal((100_352, 512)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    g16 = torch.from_numpy(g).cuda().to(torch.bfloat16)
    q = torch.from_numpy(g[rng.integers(0, max(count, 1), 64)] + 0.01).cuda()
    n = torch.tensor(count, dtype=torch.int32, device="cuda")
    before = k1.launches
    sims, idx = k1.cosine_top1(q, g16, n)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ps, pi = k1.plain_cosine_top1(q, g16, n)
    assert float((sims - ps).abs().max()) <= 1e-3
    if count == 0:
        assert bool((sims == -2.0).all()) and bool((idx == 0).all())
    else:
        assert torch.equal(idx, pi)
    s_int, i_int = k1.cosine_top1(q, g16, count)
    assert torch.equal(sims, s_int) and torch.equal(idx, i_int)
