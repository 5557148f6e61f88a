"""Kernel K2 on the card: the CUDA tracker scan against its plain version.

Needs an NVIDIA card and nvcc, and skips without them.  This file
imports no JAX, so it runs on the machine with the card, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_track_scan_cuda.py -q

ids, masks, provenance, ages, boxes, the table's integers, next_id and
the identity outputs are equal on every frame, and the active tracks' KF
state too (max error 0.0): the kernel rounds as the plain version does.
The capacity cases (T = 256 / K = 128, T = K = 192, T = 512 / K = 256,
T = 1024 / K = 64) keep the cost, and from T = 512 P, outside shared
memory."""

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
    for name in ("tid", "mask", "src_det", "age", "boxes"):
        assert torch.equal(getattr(out, name), getattr(want, name)), name
    for name in ("tid", "age", "tsu", "hits", "streak", "active", "next_id"):
        assert torch.equal(getattr(table, name), getattr(want_table, name)), name
    act = want_table.active
    for name in ("x", "p"):
        err = (getattr(table, name)[act] - getattr(want_table, name)[act]).abs().max()
        assert float(err) == 0.0, (name, float(err))


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
    stats = torch.zeros(len(K2.STATS), dtype=torch.int64, device=cuda_device)
    got_table, out = K2.sort_scan(table, boxes, mask, cfg, stats=stats)
    torch.cuda.synchronize()
    assert K2.launches == before + 1 and got_table is table
    _assert_same(out, want, table, want_table)
    jv_frames, predicted, updated = stats.tolist()[:3]
    assert predicted >= updated and (updated > 0 or b == 1)
    if t == 192:
        assert jv_frames > 0


@pytest.mark.parametrize("t,k,b,n_obj,area", [
    (256, 128, 6, 200, 700.0),
    (192, 192, 6, 240, 800.0),
    (512, 256, 4, 400, 1100.0),
    (1024, 64, 4, 120, 500.0),  # more columns than registers hold: the JV state in memory
])
def test_sort_scan_kernel_takes_large_tables(cuda_device, t, k, b, n_obj, area):
    """Tables beyond one block's shared memory, two frames tracked by the plain
    version first so that the launch's frames start crowded (JV)."""
    cfg = TrackerConfig(max_tracks=t)
    plan = K2.launch_plan(t, k)
    assert "cost" in plan.placed("scratch") and plan.shared_bytes <= K2.MAX_SHARED_BYTES
    boxes, mask = random_sequence(t + k, b + 2, k, n_obj, area=area, size=(50, 90), speed=4.0)
    boxes, mask = torch.from_numpy(boxes).cuda(), torch.from_numpy(mask).cuda()
    table, _ = K2.sort_scan_plain(make_table(cfg, cuda_device), boxes[:2], mask[:2], cfg)
    boxes, mask = boxes[2:].contiguous(), mask[2:].contiguous()
    want_table, want = K2.sort_scan_plain(_clone(table), boxes, mask, cfg)
    stats = torch.zeros(len(K2.STATS), dtype=torch.int64, device=cuda_device)
    _, out = K2.sort_scan(table, boxes, mask, cfg, stats=stats)
    torch.cuda.synchronize()
    _assert_same(out, want, table, want_table)
    assert int(stats[0]) > 0, "no frame took the JV solve"


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


def test_misaligned_inputs_are_copied_for_the_bulk_copies(cuda_device):
    """A view whose mask starts off a 16-byte boundary (frame 1 of 8-slot
    frames): the wrapper copies it for the staging copies, and the scan
    equals the plain version's."""
    cfg = TrackerConfig(max_tracks=64)
    boxes, mask = random_sequence(5, 9, 8, 6)
    boxes, mask = torch.from_numpy(boxes).cuda()[1:], torch.from_numpy(mask).cuda()[1:]
    assert mask.data_ptr() % 16 != 0 and K2.launch_plan(64, 8).chunk_frames > 0
    table = make_table(cfg, cuda_device)
    want_table, want = K2.sort_scan_plain(_clone(table), boxes, mask, cfg)
    _, out = K2.sort_scan(table, boxes, mask, cfg)
    torch.cuda.synchronize()
    _assert_same(out, want, table, want_table)
