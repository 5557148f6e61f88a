"""The traffic generator: seeded, the stated face counts, sizes, dwell
and turnover, no overlap, and the same schedule for every seed."""

import numpy as np
import pytest

from harness import spec, traffic
from harness.check import _iou


def small(name, **kw):
    mix = spec.mix(name)
    mix.update({"frame_hw": [270, 480], "face_px": [40, 70], "loop_frames": 120}, **kw)
    return mix


@pytest.mark.parametrize("name", ["live", "crowd-b64"])
def test_same_seed_same_frames(name):
    mix = small(name, loop_frames=12)
    a, b = traffic.render(mix, 2**31 + 3), traffic.render(mix, 2**31 + 3)
    assert all((x == y).all() for x, y in zip(a.frames, b.frames))
    c = traffic.render(mix, 2**31 + 4)
    assert any((x != y).any() for x, y in zip(a.frames, c.frames))
    assert a.frames[0].shape == (270, 480, 3) and a.frames[0].dtype == np.uint8


@pytest.mark.parametrize("name", ["live", "crowd-b64", "live-4cards"])
def test_counts_and_sizes(name):
    mix = spec.mix(name)
    actors = traffic.schedule(mix)
    n = mix["loop_frames"]
    per_frame = np.zeros(n, int)
    for a in actors:
        per_frame[a.start : a.end] += 1
        assert mix["face_px"][0] <= a.size <= mix["face_px"][1]
    assert per_frame.min() >= mix["faces"][0] and per_frame.max() <= mix["faces"][1]


def test_crowd_dwell():
    mix = spec.mix("crowd-b64")
    lo, hi = mix["dwell"]
    n = mix["loop_frames"]
    lives = [a.end - a.start for a in traffic.schedule(mix) if a.end < n]
    assert lives and min(lives) >= 1 and max(lives) <= hi
    assert np.median(lives) >= lo


def test_live_turnover_share():
    mix = spec.mix("live")
    starts = [a.start for a in traffic.schedule(mix) if a.start > 0]
    share = len(set(starts)) / mix["loop_frames"]
    assert abs(share - mix["turnover"]) < 0.06


def test_schedule_same_for_every_seed():
    mix = small("live", loop_frames=40)
    a, b = traffic.render(mix, 1), traffic.render(mix, 2**33 + 1)
    assert sorted(a.faces_per_frame()) == sorted(b.faces_per_frame())


@pytest.mark.parametrize("name", ["live", "crowd-b64"])
def test_faces_never_overlap(name):
    loop = traffic.render(small(name, loop_frames=30), 5)
    for t in loop.truth:
        if len(t) > 1:
            m = _iou(t[:, 2:], t[:, 2:])
            np.fill_diagonal(m, 0)
            assert m.max() == 0
