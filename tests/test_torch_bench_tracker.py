"""``fire_tpu_torch.bench.tracker`` (the port of ``bench_tracker.py``)
against JAX's ``lax.scan`` over ``sort_step`` on the same boxes, B = 16,
for all four variants: the per-frame counts of confirmed tracks are
equal exactly, the final table's boxes (the KF state's first four
components of the active tracks) agree to rtol 1e-5, and the tables'
ids, hits and active masks are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.config import TrackerConfig as JTrackerConfig
from fire_tpu.track import sort as JS
from fire_tpu_torch.bench import tracker
from fire_tpu_torch.config import TrackerConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

B = 16


def _jax_scan(cfg, boxes, mask):
    """``bench_tracker.py:50-58``, returning each frame's count."""
    def step(tb, fr):
        b, m = fr
        tb, out = JS.sort_step(tb, b, m, cfg)
        return tb, out.mask.sum()

    return jax.jit(lambda t, b, m: jax.lax.scan(step, t, (b, m)))(
        JS.make_table(cfg), jnp.asarray(boxes), jnp.asarray(mask))


def test_workload_is_bench_trackers():
    """``bench_tracker.py:34-48``: K = 8 80-px boxes moving from
    ``default_rng(0)``'s draws."""
    boxes, mask = tracker.workload(B)
    rng = np.random.default_rng(0)
    base, vel = rng.uniform(100, 900, (8, 2)), rng.uniform(-3, 3, (8, 2))
    for b in range(B):
        base = base + vel
        np.testing.assert_array_equal(boxes[b, :, :2], base.astype(np.float32))
    assert boxes.dtype == np.float32 and (boxes[..., 2:] == 80).all() and mask.all()
    assert mask.shape == (B, 8)


@pytest.mark.parametrize("name", list(tracker.VARIANTS))
def test_scan_matches_jax(name):
    kw = tracker.VARIANTS[name]
    boxes, mask = tracker.workload(B)
    jtable, jcounts = _jax_scan(JTrackerConfig(**kw), boxes, mask)
    with torch.inference_mode():
        ttable, tcounts = tracker.scan(TrackerConfig(**kw), torch.from_numpy(boxes),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert int(tcounts.sum()) > 0
    active = np.asarray(jtable.active)
    np.testing.assert_array_equal(ttable.active.numpy(), active)
    np.testing.assert_array_equal(ttable.tid.numpy(), np.asarray(jtable.tid))
    np.testing.assert_array_equal(ttable.hits.numpy(), np.asarray(jtable.hits))
    np.testing.assert_allclose(ttable.x.numpy()[active, :4], np.asarray(jtable.x)[active, :4],
                               rtol=1e-5)


def test_run_reports_every_variant_in_ms_a_frame():
    rec = tracker.run("cpu", batch=B, trials=1)
    assert rec["metric"] == "tracker scan ms/frame"
    assert list(rec["variants"]) == ["lap_T64", "lap_T32", "greedy_T64", "greedy_T32"]
    assert all(v > 0 for v in rec["variants"].values())
