"""Host tracker API of the port vs ``fire_tpu.track``: ``Sort.update``,
``hungarian_assign`` and ``MerweUKF``.

* ``Sort.update`` over a 40-frame script with births, dropouts,
  coasting (frames without detection) and deaths, under all three
  ``assignment`` modes: the same ids, ages and detection provenance,
  boxes within ±1 px (int truncation of float32 states that differ in
  the last bits).
* ``hungarian_assign``: the same matches as the JAX package's host
  solver.
* ``MerweUKF``: one predict and one update from the same float32 inputs
  agree with JAX to 1e-5 (alpha = 0.5, where float32 carries the
  weights); in float64 the port follows the numpy oracle over five
  chained steps to 1e-9, and to 1e-4 at the tracker's alpha = 1e-3,
  whose centre weight of about −1e6 amplifies rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.config import TrackerConfig as JTrackerConfig
from fire_tpu.track import assignment as JA
from fire_tpu.track.sort import Sort as JSort
from fire_tpu.track.ukf import MerweUKF as JUKF
from fire_tpu_torch.config import TrackerConfig
from fire_tpu_torch.track import assignment as TA
from fire_tpu_torch.track import sort as TS
from fire_tpu_torch.track.ukf import MerweUKF
from tests.golden_sort import NumpyMerweUKF


def script(seed, n_frames=40, detect_every=1):
    """Two faces on crossing paths, a third born at frame 12, the first
    leaving at frame 26; 15% dropouts; detections only on every
    ``detect_every``-th frame (the tracker coasts in between)."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        boxes = [[500 - 5 * f, 80 + 3 * f, 70, 75]]
        if f < 26:
            boxes.append([50 + 4 * f, 60 + 2 * f, 80, 90])
        if f >= 12:
            boxes.append([300, 420 - 3 * (f - 12), 60, 64])
        dets = [{"bbox": [v + int(rng.integers(-2, 3)) for v in b], "confidence": 0.9}
                for b in boxes if rng.random() >= 0.15]
        frames.append(dets if f % detect_every == 0 else [])
    return frames


@pytest.mark.parametrize("detect_every", [1, 3])
@pytest.mark.parametrize("assignment", ["hungarian", "greedy", "hungarian_host"])
def test_sort_update_matches_jax(assignment, detect_every):
    jcfg = JTrackerConfig(assignment=assignment, max_tracks=16)
    tcfg = TrackerConfig(assignment=assignment, max_tracks=16)
    js, ts = JSort(jcfg, max_dets=8), TS.Sort(tcfg, max_dets=8, device="cpu")
    ids, n_out = set(), 0
    for f, dets in enumerate(script(5, detect_every=detect_every)):
        j, t = js.update(dets), ts.update(dets)
        assert [d["id"] for d in t] == [d["id"] for d in j], f
        for a, b in zip(j, t):
            assert sorted(b) == ["age", "bbox", "id", "src_det"]
            assert all(isinstance(v, int) for v in b["bbox"])
            assert b["age"] == a["age"] and b["src_det"] == a["src_det"], f
            assert np.abs(np.subtract(a["bbox"], b["bbox"])).max() <= 1, f
        ids.update(d["id"] for d in t)
        n_out += len(t)
    if detect_every == 1:
        assert len(ids) >= 3 and n_out > 60  # births happened and tracks were confirmed
    ts.reset()
    assert ts.update([]) == [] and not bool(ts.table.active.any())


def test_sort_update_provenance_and_cap():
    """``src_det`` names the detection that fed the track this frame, −1
    when it coasted; detections past ``max_dets`` are dropped."""
    ts = TS.Sort(TrackerConfig(min_hits=1, max_tracks=8), max_dets=2, device="cpu")
    dets = [{"bbox": [10, 10, 50, 50]}, {"bbox": [200, 200, 60, 60]}, {"bbox": [400, 50, 40, 40]}]
    ts.update(dets)
    out = ts.update(dets[::-1][1:])  # [200-box, 10-box]: order swapped, third dropped
    assert len(out) == 2
    by_x = {d["bbox"][0] // 100: d["src_det"] for d in out}
    assert by_x == {0: 1, 2: 0}
    assert [d["src_det"] for d in ts.update([])] == [-1, -1]


@pytest.mark.parametrize("seed", range(4))
def test_hungarian_assign_matches_jax(seed):
    rng = np.random.default_rng(seed)
    d, t = int(rng.integers(2, 9)), int(rng.integers(2, 11))
    cost = rng.uniform(0.0, 2.5, (d, t)).astype(np.float32)
    dm, tm = rng.random(d) < 0.8, rng.random(t) < 0.8
    np.testing.assert_array_equal(TA.hungarian_assign(cost, dm, tm, 1.7),
                                  JA.hungarian_assign(cost, dm, tm, 1.7))
    none = TA.hungarian_assign(cost, np.zeros(d, bool), tm, 1.7)
    assert none.dtype == np.int32 and (none == -1).all()


def _spd(rng, n, scale=1.0):
    a = rng.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)) * scale


@pytest.mark.parametrize("seed", range(3))
def test_merwe_ukf_step_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 6
    f = (np.eye(n) + 0.1 * rng.standard_normal((n, n))).astype(np.float32)
    x, p = rng.standard_normal(n).astype(np.float32), _spd(rng, n).astype(np.float32)
    q, r = _spd(rng, n, 0.1).astype(np.float32), (np.eye(3) * 2.0).astype(np.float32)
    z = rng.standard_normal(3).astype(np.float32)
    ju = JUKF(n=n, fx=lambda s: jnp.asarray(f) @ s, hx=lambda s: s[:3], alpha=0.5)
    tu = MerweUKF(n=n, fx=lambda s: torch.from_numpy(f) @ s, hx=lambda s: s[:3], alpha=0.5)
    assert tu.lambda_ == ju.lambda_
    for a, b in zip(tu.weights(torch.zeros(1)), ju.weights()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    jx, jp, jsig = ju.predict(jnp.asarray(x), jnp.asarray(p), jnp.asarray(q))
    tx, tp, tsig = tu.predict(torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(q))
    for a, b in ((tx, jx), (tp, jp), (tsig, jsig)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    # the update from the same predicted state on both sides
    pred = [np.array(v) for v in (jx, jp, jsig)]
    jx2, jp2 = ju.update(jx, jp, jsig, jnp.asarray(z), jnp.asarray(r))
    tx2, tp2 = tu.update(*(torch.from_numpy(v) for v in pred), torch.from_numpy(z),
                         torch.from_numpy(r))
    np.testing.assert_allclose(tx2.numpy(), np.asarray(jx2), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("alpha", [0.5, 1e-3])
def test_merwe_ukf_float64_follows_the_oracle(alpha):
    rng = np.random.default_rng(11)
    n = 6
    f = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    gold = NumpyMerweUKF(n, 3, lambda s: f @ s, lambda s: s[:3], alpha=alpha)
    gold.x, gold.P = rng.standard_normal(n), _spd(rng, n)
    gold.Q, gold.R = _spd(rng, n, 0.1), np.eye(3) * 2.0
    ft = torch.from_numpy(f)
    tu = MerweUKF(n=n, fx=lambda s: ft @ s, hx=lambda s: s[:3], alpha=alpha)
    x, p = torch.from_numpy(gold.x.copy()), torch.from_numpy(gold.P.copy())
    q, r = torch.from_numpy(gold.Q), torch.from_numpy(gold.R)
    tol = 1e-9 if alpha == 0.5 else 1e-4  # Wc₀ ≈ −1e6 at alpha = 1e-3 amplifies rounding
    for _ in range(5):
        gold.predict()
        x, p, sig = tu.predict(x, p, q)
        np.testing.assert_allclose(x.numpy(), gold.x, atol=tol)
        np.testing.assert_allclose(p.numpy(), gold.P, atol=tol)
        z = rng.standard_normal(3)
        gold.update(z)
        x, p = tu.update(x, p, sig, torch.from_numpy(z), r)
        np.testing.assert_allclose(x.numpy(), gold.x, atol=tol)
        np.testing.assert_allclose(p.numpy(), gold.P, atol=tol)
    assert x.dtype == torch.float64
