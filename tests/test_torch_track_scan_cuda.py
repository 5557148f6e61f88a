"""Kernel K2 on the card: the CUDA tracker scan against its plain version.

Needs an NVIDIA card and nvcc, and skips without them.  This file
imports no JAX, so it runs on the machine with the card, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_track_scan_cuda.py -q

ids, masks, provenance, ages, the table's integers, next_id and the
identity outputs are equal on every frame; boxes within 1 px; the active
tracks' KF state to atol 1e-3, rtol 1e-5."""

import numpy as np
import pytest
import torch

from fire_tpu_torch.bench.tracker import random_sequence
from fire_tpu_torch.config import TrackerConfig
from fire_tpu_torch.pipeline.batch_engine import make_stream_state
from fire_tpu_torch.track import scan as K2
from fire_tpu_torch.track.sort import make_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K2 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _clone(table):
    return type(table)(*(x.clone() for x in table))


def _assert_same(out, want, table, want_table):
    for name in ("tid", "mask", "src_det", "age"):
        assert torch.equal(getattr(out, name), getattr(want, name)), name
    assert int((out.boxes - want.boxes).abs().max()) <= 1
    for name in ("tid", "age", "tsu", "hits", "streak", "active", "next_id"):
        assert torch.equal(getattr(table, name), getattr(want_table, name)), name
    act = want_table.active
    torch.testing.assert_close(table.x[act], want_table.x[act], atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(table.p[act], want_table.p[act], atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("assignment,t,k,b,n_obj,kw", [
    ("hungarian", 64, 8, 64, 10, {}),
    ("greedy", 32, 8, 64, 10, {}),
    ("hungarian", 16, 128, 8, 40, dict(area=500.0)),                   # K > T, a full table
    ("hungarian", 192, 128, 8, 150, dict(area=700.0, size=(50, 90), speed=4.0)),  # the JV solve
    ("hungarian", 64, 8, 1, 6, {}),                                    # the per-frame path
])
def test_sort_scan_kernel_matches_plain(cuda_device, assignment, t, k, b, n_obj, kw):
    cfg = TrackerConfig(assignment=assignment, max_tracks=t)
    boxes, mask = random_sequence(b * t + k, b, k, n_obj, **kw)
    boxes, mask = torch.from_numpy(boxes).cuda(), torch.from_numpy(mask).cuda()
    table = make_table(cfg, cuda_device)
    want_table, want = K2.sort_scan_plain(_clone(table), boxes, mask, cfg)
    before = K2.launches
    stats = torch.zeros(len(K2.STATS), dtype=torch.int32, device=cuda_device)
    got_table, out = K2.sort_scan(table, boxes, mask, cfg, stats=stats)
    torch.cuda.synchronize()
    assert K2.launches == before + 1 and got_table is table
    _assert_same(out, want, table, want_table)
    jv_frames, predicted, updated = stats.tolist()[:3]
    assert predicted >= updated and (updated > 0 or b == 1)
    if t == 192:
        assert jv_frames > 0


def test_track_scan_kernel_matches_plain(cuda_device):
    cfg = TrackerConfig()
    b, k = 64, 8
    boxes, mask = random_sequence(7, b, k, 20)
    rng = np.random.default_rng(8)
    det = [torch.from_numpy(x).cuda() for x in (
        rng.integers(0, 1000, (b, k)).astype(np.int32),
        rng.uniform(0.3, 0.75, (b, k)).astype(np.float32), mask & (rng.random((b, k)) < 0.8))]
    boxes, mask = torch.from_numpy(boxes).cuda(), torch.from_numpy(mask).cuda()
    state = make_stream_state(cfg, 4, cuda_device)
    ident = K2.IdentityState(state.gid, state.sim, state.unk, state.pending)
    pt, pi, pout, piout = K2.track_scan_plain(_clone(state.table), _clone(ident), boxes, mask,
                                              *det, cfg, 0.7, 1)
    table, ident, out, iout = K2.track_scan(state.table, ident, boxes, mask, *det, cfg, 0.7, 1)
    torch.cuda.synchronize()
    _assert_same(out, pout, table, pt)
    for a, w in zip((*ident, *iout), (*pi, *piout)):
        assert torch.equal(a, w)
    assert int(iout.enroll.sum()) > 8  # more than MAX_ENROLL in one batch
