"""Tracker of the port vs fire_tpu.track and the float64 golden oracle.

* ``lap_assign``: identical matches to the JAX device solver and the
  same gated optimum as the SciPy/native host solver, on gated,
  conflicted and overflow cost matrices.
* ``sort_step`` over 60-frame random sequences: ids, masks and
  detection provenance exact, boxes within ±1 px (int truncation of
  float32 states that differ in the last bits), KF state within 1e-3.
* The reference semantics, via tests/golden_sort.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.config import TrackerConfig as JTrackerConfig
from fire_tpu.track import assignment as JA
from fire_tpu.track import sort as JS
from fire_tpu_torch.config import TrackerConfig
from fire_tpu_torch.track import assignment as TA
from fire_tpu_torch.track import sort as TS
from fire_tpu_torch.track import ukf as TU
from tests.golden_sort import GoldenSort

GATE = (1.0 - 0.3) + 1.0


def _gated_total(cost, match):
    pairs = [(int(d), t) for t, d in enumerate(np.asarray(match)) if d >= 0]
    return sum(float(cost[d, t]) for d, t in pairs), len(pairs)


def _lap_case(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "gated":
        d, t = rng.integers(2, 10), rng.integers(2, 12)
        cost = rng.uniform(1.0, 3.0, (d, t)).astype(np.float32)  # many above the gate
    elif kind == "conflicted":
        d, t = 6, 8
        base = rng.uniform(0.0, 0.2, (d, 1)).astype(np.float32)
        cost = (base + rng.uniform(0.0, 0.3, (d, t))).astype(np.float32)
        cost[:, 0] -= 0.5  # every row's cheapest column is column 0
    else:  # overflow: more detection slots than tracks, some masked
        d, t = 12, 5
        cost = rng.uniform(0.0, 2.5, (d, t)).astype(np.float32)
    det_mask = rng.random(d) < 0.85
    trk_mask = rng.random(t) < 0.85
    det_mask[0] = trk_mask[0] = True
    return cost, det_mask, trk_mask


@pytest.mark.parametrize("kind", ["gated", "conflicted", "overflow"])
@pytest.mark.parametrize("seed", range(4))
def test_lap_assign_matches_jax_and_oracle(kind, seed):
    cost, dm, tm = _lap_case(kind, seed)
    t = TA.lap_assign(torch.from_numpy(cost), torch.from_numpy(dm), torch.from_numpy(tm), GATE)
    j = np.asarray(JA.lap_assign(jnp.asarray(cost), jnp.asarray(dm), jnp.asarray(tm), GATE))
    np.testing.assert_array_equal(t.numpy(), j)
    host = JA.hungarian_assign(cost, dm, tm, GATE)
    tt, nt = _gated_total(cost, t.numpy())
    th, nh = _gated_total(cost, host)
    assert nt == nh and abs(tt - th) < 1e-4


def test_greedy_and_cost_matrix_match_jax():
    rng = np.random.default_rng(7)
    det = np.concatenate([rng.uniform(0, 500, (6, 2)), rng.uniform(20, 90, (6, 2))], 1).astype(np.float32)
    trk = np.concatenate([rng.uniform(0, 500, (9, 2)), rng.uniform(20, 90, (9, 2))], 1).astype(np.float32)
    trk[3, 2] = 0.0  # degenerate box
    c_t = TA.cost_matrix(torch.from_numpy(det), torch.from_numpy(trk))
    c_j = np.asarray(JA.cost_matrix(jnp.asarray(det), jnp.asarray(trk)))
    np.testing.assert_allclose(c_t.numpy(), c_j, atol=1e-5)
    dm, tm = np.ones(6, bool), rng.random(9) < 0.8
    g_t = TA.greedy_assign(c_t, torch.from_numpy(dm), torch.from_numpy(tm), 10.0, 6)
    g_j = JA.greedy_assign(jnp.asarray(c_j), jnp.asarray(dm), jnp.asarray(tm), 10.0, max_pairs=6)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


def test_inv4_and_kf_update_match_jax():
    from fire_tpu.track import ukf as JU

    rng = np.random.default_rng(8)
    a = rng.standard_normal((5, 10, 10)).astype(np.float32)
    p = (a @ a.transpose(0, 2, 1) + 10 * np.eye(10)).astype(np.float32)
    x = rng.standard_normal((5, 10)).astype(np.float32)
    z = rng.standard_normal((5, 4)).astype(np.float32)
    xt, pt = TU.kf_update_tracker(torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(z), 10.0)
    for i in range(5):
        xj, pj = JU.kf_update_tracker(jnp.asarray(x[i]), jnp.asarray(p[i]), jnp.asarray(z[i]), 10.0)
        np.testing.assert_allclose(xt[i].numpy(), np.asarray(xj), atol=1e-4)
        np.testing.assert_allclose(pt[i].numpy(), np.asarray(pj), atol=1e-3)
    np.testing.assert_array_equal(TU.tracker_f_matrix().numpy(), np.asarray(JU.tracker_f_matrix()))
    np.testing.assert_array_equal(TU.tracker_h_matrix().numpy(), np.asarray(JU.tracker_h_matrix()))


def _random_sequence(seed, n_frames=60, k=8):
    """Objects on noisy linear paths with births, deaths and dropouts,
    packed into k padded detection slots per frame."""
    rng = np.random.default_rng(seed)
    n_obj = 6
    start = rng.integers(0, 50, n_obj)
    life = rng.integers(15, 60, n_obj)
    pos = rng.uniform(50, 900, (n_obj, 2))
    vel = rng.uniform(-8, 8, (n_obj, 2))
    size = rng.uniform(40, 160, (n_obj, 2))
    boxes = np.zeros((n_frames, k, 4), np.float32)
    mask = np.zeros((n_frames, k), bool)
    for f in range(n_frames):
        slot = 0
        for o in rng.permutation(n_obj):
            if not (start[o] <= f < start[o] + life[o]) or rng.random() < 0.15:
                continue
            p = pos[o] + vel[o] * (f - start[o]) + rng.normal(0, 2, 2)
            boxes[f, slot] = [*np.round(p), *np.round(size[o] + rng.normal(0, 2, 2))]
            mask[f, slot] = True
            slot += 1
    return boxes, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("assignment", ["hungarian", "greedy"])
def test_sort_step_sequences_match_jax(seed, assignment):
    boxes, mask = _random_sequence(seed)
    jcfg, tcfg = JTrackerConfig(assignment=assignment, max_tracks=16), TrackerConfig(
        assignment=assignment, max_tracks=16)
    jt, tt = JS.make_table(jcfg), TS.make_table(tcfg)
    n_confirmed = 0
    for f in range(boxes.shape[0]):
        jt, jo = JS.sort_step(jt, jnp.asarray(boxes[f]), jnp.asarray(mask[f]), jcfg)
        tt, to = TS.sort_step(tt, torch.from_numpy(boxes[f]), torch.from_numpy(mask[f]), tcfg)
        for name in ("tid", "mask", "src_det", "age"):
            np.testing.assert_array_equal(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                          err_msg=f"frame {f} {name}")
        m = np.asarray(jo.mask)
        assert np.abs(to.boxes.numpy()[m] - np.asarray(jo.boxes)[m]).max(initial=0) <= 1
        act = np.asarray(jt.active)
        np.testing.assert_array_equal(tt.active.numpy(), act)
        np.testing.assert_allclose(tt.x.numpy()[act], np.asarray(jt.x)[act], atol=1e-3, rtol=1e-5)
        np.testing.assert_allclose(tt.p.numpy()[act], np.asarray(jt.p)[act], atol=1e-3, rtol=1e-5)
        assert int(tt.next_id) == int(jt.next_id)
        n_confirmed += int(m.sum())
    assert n_confirmed > 50


def _scene(n_frames=40, seed=0, dropout=0.2):
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        boxes = [[50 + 4 * f, 60 + 2 * f, 80, 90], [500 - 4 * f, 80 + 3 * f, 70, 75]]
        if f >= 15:
            boxes.append([300, 400 - 2 * (f - 15), 60, 60])
        frames.append([{"bbox": [v + int(rng.integers(-2, 3)) for v in b], "confidence": 0.95}
                       for b in boxes if rng.random() >= dropout])
    return frames


@pytest.mark.parametrize("seed,skip_every", [(3, 0), (0, 2)])
def test_sort_matches_golden_oracle(seed, skip_every):
    cfg = TrackerConfig()
    table = TS.make_table(cfg)
    gold = GoldenSort(max_age=cfg.max_age, min_hits=cfg.min_hits, iou_threshold=cfg.iou_threshold)
    for i, dets in enumerate(_scene(seed=seed)):
        d = [] if (skip_every and i % skip_every) else dets
        boxes = np.zeros((32, 4), np.float32)
        mask = np.zeros(32, bool)
        for j, det in enumerate(d):
            boxes[j], mask[j] = det["bbox"], True
        table, out = TS.sort_step(table, torch.from_numpy(boxes), torch.from_numpy(mask), cfg)
        ours = {int(t): (out.boxes[s].numpy(), int(out.age[s]))
                for s, t in enumerate(out.tid.numpy()) if out.mask[s]}
        g = {t["id"]: t for t in gold.update(d)}
        assert set(ours) == set(g), i
        for tid, (box, age) in ours.items():
            assert np.abs(box - np.asarray(g[tid]["bbox"])).max() <= 2
            assert age == g[tid]["age"]
